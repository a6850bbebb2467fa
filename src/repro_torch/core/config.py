"""Configuration dataclasses (the port's own copy of ``repro.core.config``).

``ModelConfig`` keeps exactly the reference's fields and defaults, so a
reference config converts with ``ModelConfig(**dataclasses.asdict(cfg))``
and both packages derive the same shapes (``padded_vocab``,
``resolved_head_dim``) from it.  Only ``kernel_impl`` takes the port's
own values.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


VOCAB_DIVISOR = 256  # Megatron make_vocab_size_divisible_by — faithful.


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description.  One instance per model-zoo entry."""

    name: str
    family: str  # dense | ssm | moe | hybrid | audio | vlm | bio_bert | bio_encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- attention options ---
    qkv_bias: bool = False
    attn_out_bias: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True
    max_pos: int = 0                   # learned absolute positions (use_rope=False)
    sliding_window: int = 0            # 0 = full attention
    causal: bool = True
    attn_logit_softcap: float = 0.0

    # --- block options ---
    norm_type: str = "rmsnorm"         # rmsnorm | layernorm | layernorm_nobias
    act: str = "swiglu"                # swiglu | gelu | geglu | relu
    mlp_bias: bool = False
    parallel_residual: bool = False    # command-r style parallel attn+ffn
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 1
    moe_layer_period: int = 1
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    router_entropy_coef: float = 0.0

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    ssm_ngroups: int = 1
    ssm_conv: int = 4
    attn_layer_period: int = 0

    # --- encoder/decoder & modality frontends ---
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    frontend: str = ""                 # "" | audio_stub | vision_stub
    num_frontend_tokens: int = 0
    cross_attn_heads: int = 0

    # --- objective (bio recipes) ---
    objective: str = "clm"             # clm | mlm | seq2seq
    mlm_mask_prob: float = 0.15

    # --- numerics / kernels ---
    dtype: str = "bfloat16"            # activation/compute dtype
    param_dtype: str = "float32"       # stored parameter dtype
    # hot-path ops (attention, norms, sampling, grouped matmul, SSD scan): "auto"
    # launches the hand-written kernel for a CUDA tensor and the plain
    # PyTorch version for a CPU tensor; "torch" forces the plain version
    # (tests and chip_smoke.py)
    kernel_impl: str = "auto"
    citation: str = ""

    # ------------------------------------------------------------------ #
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, VOCAB_DIVISOR)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def is_moe_layer(self, layer_idx: int) -> bool:
        if self.num_experts == 0:
            return False
        return (layer_idx % self.moe_layer_period) == (self.moe_layer_period - 1)

    def is_attn_layer(self, layer_idx: int) -> bool:
        """Hybrid (jamba) interleave: one attention layer per attn_layer_period."""
        if self.family == "ssm":
            return False
        if self.family != "hybrid":
            return True
        p = self.attn_layer_period
        return (layer_idx % p) == (p // 2)  # jamba places attn mid-group

    def _mlp_params(self) -> int:
        return (3 if self.act in ("swiglu", "geglu") else 2) * self.d_model * self.d_ff

    def param_count(self) -> int:
        """Analytic parameter count of a decoder stack — attention, SSM
        (Mamba-2) or a hybrid of both, each with a dense or MoE FFN —
        counted as the reference counts it: embedding included once, twice
        when untied; MoE counts every expert, the shared ones and the
        router; an SSM block its projections and A, D, dt_bias (not its
        conv or its gated norm).  An encoder-decoder adds its encoder
        layers and each decoder layer's cross-attention and its norm (not
        the encoder's final norm, position table or a projector)."""
        d, hd = self.d_model, self.resolved_head_dim
        att = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
        di, nh = self.d_inner, self.ssm_nheads
        ssm = d * (2 * di + 2 * self.ssm_ngroups * self.ssm_state + nh) + di * d + 3 * nh
        total = 0
        for i in range(self.num_layers):
            total += (att if self.is_attn_layer(i) else ssm) + 2 * d
            if self.is_moe_layer(i):
                total += (self.num_experts + self.n_shared_experts) * self._mlp_params()
                total += d * self.num_experts
            elif self.d_ff > 0:
                total += self._mlp_params()
        total += self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        if self.is_encoder_decoder:
            total += self.encoder_layers * (att + self._mlp_params() + 2 * d)
            total += self.num_layers * (att + d)
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only the routed experts)."""
        unused = sum(self.num_experts - self.num_experts_per_tok
                     for i in range(self.num_layers) if self.is_moe_layer(i))
        return self.param_count() - unused * self._mlp_params()


REMAT_POLICIES = ("none", "block", "dots", "full")


ATTENTION_PARALLELISM = ("head_tp", "context")


@dataclass(frozen=True)
class ParallelConfig:
    """How a model maps onto the mesh (``parallel/sharding.py``), with the
    reference's fields and defaults.

    attention_parallelism — what the ``model`` axis splits:
      * "head_tp" — the query heads and the MLP's d_ff (Megatron): the K/V
                    heads too where ``num_kv_heads % tp == 0``, else every
                    rank holds all K/V heads and uses its query heads' ones;
                    needs ``num_heads % tp == 0`` (``validate``).  It trains
                    and serves: prefill, chunked prefill and decode run at
                    the rank's heads over K/V caches of its K/V heads;
      * "context" — the sequence: a rank holds its rows of the residual
                    stream and all-gathers K/V in attention; no head
                    constraint.  It trains and embeds (``embed_pool``);
                    generation under it is ROADMAP item 14e (the
                    sequence-sharded cache) and raises.
    fsdp_axes — the mesh axes the master params and the AdamW moments are
      sharded over (FSDP); each step gathers their compute view over them.
    remat_policy — what a training step keeps of each unit of the stack
      for the backward (``models/transformer.py::_remat_wrap``):
      * "none"  — every activation;
      * "block" — only the unit's inputs; the unit runs again in the
                  backward;
      * "dots"  — the outputs of the 2-D matmuls; the rest runs again;
      * "full"  — everything, as "none".
    optimizer_state_dtype — the AdamW moments' dtype.

    The reference's ``expert_axis`` and ``shard_cache_seq`` come with the
    paths that read them (expert parallelism, item 14b; the
    sequence-sharded dense cache, item 14e); until then ``axis_rules`` maps
    "experts" and "cache_seq" to ``model``, their defaults.  Serving keeps
    the K/V caches split by K/V head over ``model`` and whole over ``data``
    (the data ranks are replicas; splitting the slots over ``data`` is item
    14d).  Its ``scan_layers`` and ``donate_params`` have no
    counterpart: the port loops over the units and updates the state in
    place."""

    attention_parallelism: str = "head_tp"   # head_tp | context
    fsdp_axes: Tuple[str, ...] = ("data",)   # axes weights are FSDP-sharded over
    remat_policy: str = "block"              # none | block | dots | full
    optimizer_state_dtype: str = "float32"   # float32 | bfloat16

    def __post_init__(self):
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {self.remat_policy!r} is not one of "
                             f"{REMAT_POLICIES}")
        if self.attention_parallelism not in ATTENTION_PARALLELISM:
            raise ValueError(f"attention_parallelism {self.attention_parallelism!r} is not one "
                             f"of {ATTENTION_PARALLELISM}")
        if "model" in self.fsdp_axes:
            raise ValueError("fsdp_axes take the batch axes (pod, data), not model")

    def validate(self, mc: ModelConfig, tp: int) -> "ParallelConfig":
        """head_tp -> context when the heads do not divide over ``tp``, the
        reference's rule."""
        if self.attention_parallelism == "head_tp" and mc.num_heads % tp != 0:
            return dataclasses.replace(self, attention_parallelism="context")
        return self


@dataclass(frozen=True)
class TrainConfig:
    """The reference's training knobs, same fields and defaults."""

    global_batch: int = 256
    seq_len: int = 4096
    # microbatch gradient accumulation: each optimizer step runs
    # accum_steps microbatches of global_batch/accum_steps rows with fp32
    # grad accumulators, token-weighted, so accum_steps=N equals one
    # N×-larger batch (training/train_step.py)
    accum_steps: int = 1
    learning_rate: float = 1e-3
    min_lr: float = 1e-5
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 1000
    total_steps: int = 1000
    schedule: str = "wsd"      # wsd | cosine | noam | const
    seed: int = 0
    log_every: int = 10
    ckpt_every: int = 0        # 0 = disabled
    ckpt_dir: str = ""
    # non-finite guard: a step whose loss or global grad-norm is not finite
    # applies no update and is counted as a skip; this many consecutive
    # skips abort the run (training/loop.py)
    max_nonfinite_skips: int = 10


@dataclass(frozen=True)
class ServeConfig:
    """Serving knobs: the reference's fields, for the dense and the paged
    layout."""

    max_seq_len: int = 32768
    batch_size: int = 128
    # default sampling knobs, mapped into a default SamplingParams by the
    # LLM facade; each request may carry its own SamplingParams
    temperature: float = 0.0   # 0 = greedy
    top_k: int = 0             # 0 = disabled
    top_p: float = 1.0         # 1.0 = disabled
    seed: int = 0              # keys the counter-based sampling hash
    # KV-cache layout of the continuous-batching engine: "dense" per-slot
    # buffers, or "paged" block-table pages over a shared pool
    # (serving/paged_cache.py + kernels/paged_attention.py)
    cache_layout: str = "dense"
    page_size: int = 16        # tokens per page in the paged layout
    # paged-layout features:
    #   prefix_cache — content-addressed sharing of full prompt blocks
    #   (refcounted pages, copy-on-write, LRU eviction of unreferenced
    #   cached pages); prefill skips hash-hit blocks entirely.
    #   prefill_chunk — bound each prefill step to N tokens, interleaved
    #   with decode iterations (0 = prefill the suffix in one chunk).
    prefix_cache: bool = False
    prefill_chunk: int = 0
    # bounded admission queue (0 = unbounded): a full queue rejects at
    # submit with the retriable EngineOverloaded
    max_queue: int = 0
    # under page pressure, evict the newest in-flight decode and replay it
    # later (token-identical resume) instead of blocking the queue head;
    # paged layout only
    preempt: bool = False
    # default per-request wall-clock SLO from submit, in ms (None = none)
    deadline_ms: Optional[float] = None


def reduced(mc: ModelConfig, **over: Any) -> ModelConfig:
    """Smoke-test variant of a config: <=2 layers, d_model<=256, <=4 experts.

    Same rule as the reference, so ``reduced`` of a converted config equals
    the converted ``reduced`` config.
    """
    d_model = min(mc.d_model, 256)
    nh = max(2, min(mc.num_heads, 4))
    nkv = max(1, min(mc.num_kv_heads, nh))
    while nh % nkv:
        nkv -= 1
    layers = min(mc.num_layers, 2)
    if mc.family == "hybrid":
        layers = mc.attn_layer_period
    kw = dict(
        num_layers=layers,
        d_model=d_model,
        num_heads=nh,
        num_kv_heads=nkv,
        head_dim=d_model // nh,
        d_ff=min(mc.d_ff, 512) if mc.d_ff else 0,
        vocab_size=min(mc.vocab_size, 512),
        num_experts=min(mc.num_experts, 4) if mc.num_experts else 0,
        encoder_layers=min(mc.encoder_layers, 2) if mc.encoder_layers else 0,
        num_frontend_tokens=min(mc.num_frontend_tokens, 16) if mc.num_frontend_tokens else 0,
        ssm_headdim=32 if mc.ssm_state else mc.ssm_headdim,
        ssm_state=min(mc.ssm_state, 16) if mc.ssm_state else 0,
        ssm_chunk=8 if mc.ssm_state else mc.ssm_chunk,
        sliding_window=min(mc.sliding_window, 64) if mc.sliding_window else 0,
        dtype="float32",
        param_dtype="float32",
    )
    kw.update(over)
    return dataclasses.replace(mc, **kw)
