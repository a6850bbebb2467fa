"""Top-level model: the param tree as an ``nn.Module`` plus the entry points
— embedding extraction, the training loss, and generation over a dense or
a paged KV cache (``prefill``, ``prefill_chunk``, ``decode_step``,
``init_cache``), for attention, SSM and hybrid stacks, encoder-decoders and
the two frontend stubs.

An encoder-decoder (MolMIM, Whisper) runs its encoder (``_encode``) over
``src_tokens`` through the shared embedding or over precomputed frame
embeddings ``enc_embeds`` plus the encoder's position table, then the
decoder with cross-attention to the encoder output; prefill stores each
layer's cross K/V once (``init_cache(cross_len=…)`` preallocates it).  A
vision model (InternVL2) projects ``img_embeds`` into the stream in front
of the text; its loss leaves those rows out.

``build_model(cfg)`` materializes seeded random weights on the GPU; pass
``device="cpu"`` to run on the CPU (the tests do).  Weights from the
reference package cross in through ``checkpoint/bridge.py``:
``Model(cfg, from_jax_params(tree))``.  A model keeps its
``ParallelConfig`` (``build_model(cfg, pc)``, ``Model(cfg, params, pc)``):
in training each unit of the stack runs under its ``remat_policy``,
``block`` by default, as the reference's.

On a mesh (``build_model(cfg, pc, mesh)``, ``Model(cfg, params, pc,
mesh)``; ``parallel/sharding.py``) a model holds this rank's shard of each
leaf: every rank draws each leaf whole from its own seed and keeps its
part, so the weights are the mesh-free model's whatever the mesh's shape,
and bridged weights shard the same way.  ``compute_params`` gathers the
compute view a step works on, and ``loss_fn`` is the global token-weighted
mean over every rank's rows.  Serving reads ``serving_params()``, that
view built once without a gradient: each leaf whole over ``data`` (the
data ranks serve as replicas), the rank's heads and MLP columns over
``model`` (head-TP), the embedding and the LM head whole, so the logits
are whole on every rank.  ``init_cache`` sizes the K/V caches for the
rank's K/V heads.  ``embed_pool`` runs under head-TP and under context
parallelism; generation under context parallelism is not ported yet
(ROADMAP item 14e), and MoE, SSM, encoder-decoder and frontend models
train and serve on a mesh whose ``model`` axis is 1 (item 14b).

``loss_fn(params, batch)`` takes the param tree explicitly, as the
reference's does, so the train step can run it on the compute-dtype view
of its master copy; the serving entry points take it too.  To serve, build
the model with bf16 parameters (``dataclasses.replace(cfg,
param_dtype="bfloat16")``): each weight's cast to the compute dtype is then
a no-op, instead of a re-read and re-cast of the fp32 master copy in every
decode step.
"""
from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.core.config import ModelConfig, ParallelConfig
from repro_torch.core.module import P, ParamTree, materialize, tree_get, tree_map
from repro_torch.core.precision import compute_view, policy_for
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.parallel.sharding import ShardingCtx, mesh_axis_sizes, null_ctx, rank_kv_heads

log = logging.getLogger(__name__)


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    """The encoder stack's config: a dense bidirectional stack of
    ``encoder_layers`` layers, the reference's ``_enc_cfg``."""
    return dataclasses.replace(cfg, family="dense", num_layers=cfg.encoder_layers, num_experts=0,
                               causal=False, is_encoder_decoder=False)


def param_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """The reference's param tree: the decoder stack (with cross-attention
    for an encoder-decoder), and an encoder-decoder's ``encoder`` stack,
    final norm and, with the audio stub, its ``pos`` table of ``max_pos``
    rows; the vision stub's ``projector``."""
    defs: Dict[str, Any] = {
        "embed": L.embedding_defs(cfg),
        "layers": T.stack_defs(cfg, cross=cfg.is_encoder_decoder),
        "final_norm": L.norm_defs(cfg, cfg.d_model),
        "head": L.lm_head_defs(cfg),
    }
    if cfg.is_encoder_decoder:
        enc = encoder_config(cfg)
        defs["encoder"] = {"layers": T.stack_defs(enc),
                           "final_norm": L.norm_defs(enc, cfg.d_model)}
        if cfg.frontend == "audio_stub" and cfg.max_pos:
            defs["encoder"]["pos"] = P((cfg.max_pos, cfg.d_model), (None, "fsdp"), init="normal",
                                       scale=0.02)
    if cfg.frontend == "vision_stub":
        defs["projector"] = {"w": P((cfg.d_model, cfg.d_model), ("fsdp", "tp"), fan_in=cfg.d_model),
                             "b": P((cfg.d_model,), (None,), init="zeros")}
    return defs


def check_mesh_support(cfg: ModelConfig, tp: int) -> None:
    """Raise for a family whose ``model``-axis split is not ported: MoE
    (expert parallelism), SSM and hybrid stacks, encoder-decoders and the
    frontend models train and serve on a mesh whose ``model`` axis is 1."""
    if tp > 1 and (cfg.num_experts or cfg.family in ("ssm", "hybrid")
                   or cfg.is_encoder_decoder or cfg.frontend):
        raise NotImplementedError(
            f"{cfg.name}: a {cfg.family} model over model={tp} is not ported yet (ROADMAP: "
            "item 14b); train or serve it on a mesh whose model axis is 1 (FSDP over data, "
            "replicas when serving)")


class Model(nn.Module):
    """``pc`` (default ``ParallelConfig()``) is kept as the reference keeps
    it in its model's ``ctx``: its ``remat_policy`` sets what a training
    step keeps of each unit of the stacks, and a trainer built on the
    model reads its ``optimizer_state_dtype``.  On a ``mesh`` it is first
    ``validate``d for the ``model`` axis's size, and ``params`` (whole
    leaves or this rank's shards) are kept as this rank's shards."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any],
                 pc: Optional[ParallelConfig] = None, mesh: Any = None):
        super().__init__()
        T.check_supported(cfg)
        self.cfg = cfg
        pc = pc or ParallelConfig()
        self.pc = pc
        self.ctx = null_ctx()
        self.specs = None
        if mesh is not None:
            self.pc, self.ctx, self.specs = _mesh_layout(cfg, pc, mesh)
            if self.pc is not pc and self.ctx.is_first:
                log.warning("%s: %d heads do not divide over model=%d: attention_parallelism "
                            "head_tp -> context", cfg.name, cfg.num_heads, self.ctx.tp)
            params = self.ctx.shard_tree(self.specs, params, param_defs(cfg))
        # the serving entry points' context: the data ranks are replicas
        self.serve_ctx = self.ctx.serving()
        self.policy = policy_for(cfg)
        self.params = ParamTree(params)

    @property
    def device(self) -> torch.device:
        return self.params.embed.tok.device

    @property
    def sharded(self) -> bool:
        return self.ctx.mesh is not None

    def spec_at(self, path: Tuple[str, ...]):
        """The ``LeafSpec`` of the leaf at ``path`` (a model on a mesh)."""
        return tree_get(self.specs, path)

    def compute_params(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """The compute-dtype view of the master ``params`` that a train step
        works on: ``compute_view``, or on a mesh each leaf gathered over the
        axes its view is whole on (``ShardingCtx.gather_view``)."""
        if not self.sharded:
            return compute_view(self.policy, params)
        return self.ctx.gather_view(self.specs, params, self.policy.cdt)

    @torch.no_grad()
    def serving_params(self) -> Dict[str, Any]:
        """The weights the serving entry points read: off a mesh the
        model's own tree (no copy); on a mesh the compute view, built once
        without a gradient (``compute_params``: whole over ``data``, the
        rank's heads and MLP columns over ``model``, the embedding and the
        LM head whole)."""
        if not self.sharded:
            return self.params.tree()
        return self.compute_params(self.params.tree())

    def _check_generation(self) -> None:
        if self.ctx.seq_parallel:
            raise NotImplementedError(
                f"{self.cfg.name}: generation under context parallelism ({self.cfg.num_heads} "
                f"heads do not divide over model={self.ctx.tp}) is not ported yet (ROADMAP: "
                "item 14e, the sequence-sharded cache and flash_decode's partial LSE combined "
                "over model); embed_pool runs, or serve with heads that divide")

    # ------------------------------------------------------------ encoder
    def _encode(self, params: Dict[str, Any], batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """An encoder-decoder's encoder output (B, T_enc, d_model): over
        ``enc_embeds`` (the audio stub's frames) plus the first T_enc rows of
        the encoder's position table, or over ``src_tokens`` through the
        shared embedding; the stack is bidirectional, then its final norm."""
        cdt = self.policy.cdt
        enc = params["encoder"]
        if "enc_embeds" in batch:
            x = batch["enc_embeds"].to(cdt)
            if "pos" in enc:
                x = x + enc["pos"][: x.shape[1]].to(cdt)[None]
        else:
            x = L.embed_apply(self.cfg, params["embed"], batch["src_tokens"], compute_dtype=cdt)
        x, _, _ = T.decoder_stack(encoder_config(self.cfg), enc["layers"], x, causal=False,
                                  remat=self.pc.remat_policy)
        return L.norm_apply(self.cfg, enc["final_norm"], x)

    def _cross_kv(self, params: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        return self._encode(params, batch) if self.cfg.is_encoder_decoder else None

    # ------------------------------------------------------------ backbone
    def _decoder_input(self, params: Dict[str, Any], tokens: torch.Tensor,
                       positions: Optional[torch.Tensor] = None,
                       img: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The embedded tokens; ``positions`` reach a learned position table
        only (``L.embed_apply``).  A vision model given ``img`` (B, n_front,
        d_model) projects it and puts those rows in front of the text."""
        cdt = self.policy.cdt
        x = L.embed_apply(self.cfg, params["embed"], tokens, positions, compute_dtype=cdt)
        if img is not None and self.cfg.frontend == "vision_stub":
            proj = params["projector"]
            img = img.to(cdt) @ proj["w"].to(cdt) + proj["b"].to(cdt)
            x = torch.cat([img, x], dim=1)
        return x

    def _backbone(self, params: Dict[str, Any], x: torch.Tensor, serving: bool = False, **kw):
        """The stack (train mode unless ``kw`` says otherwise), then the
        final norm; returns (x, caches, aux_sum) — aux_sum the MoE layers'
        router vectors summed (``moe.aux_shape``).  ``serving``: under the
        serving context (``ShardingCtx.serving``)."""
        x, caches, aux = T.decoder_stack(self.cfg, params["layers"], x,
                                         remat=self.pc.remat_policy,
                                         ctx=self.serve_ctx if serving else self.ctx, **kw)
        return L.norm_apply(self.cfg, params["final_norm"], x), caches, aux

    def head_weight(self, params: Dict[str, Any]) -> torch.Tensor:
        return L.lm_head_weight(self.cfg, params["head"], params["embed"])

    def logits(self, params: Dict[str, Any], hidden: torch.Tensor) -> torch.Tensor:
        """(…, d_model) -> (…, Vpad) logits in hidden's dtype: the optional
        softcap, and −1e30 on the Megatron vocab padding."""
        cfg = self.cfg
        lg = hidden @ self.head_weight(params).to(hidden.dtype)
        if cfg.logit_softcap > 0:
            lg = cfg.logit_softcap * torch.tanh(lg / cfg.logit_softcap)
        if cfg.padded_vocab != cfg.vocab_size:
            pad = torch.arange(cfg.padded_vocab, device=lg.device) >= cfg.vocab_size
            lg = lg.masked_fill(pad, -1e30)
        return lg

    # ------------------------------------------------------------ training
    def loss_fn(self, params: Dict[str, Any], batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Masked-mean cross-entropy of a batch -> (loss, metrics).

        ``mlm``: every position predicts ``targets``, weighted by
        ``loss_mask``.  ``clm``: position t predicts token t+1, weighted by
        ``loss_mask[:, 1:]`` when given.  The loss is computed for every
        token by the fused cross-entropy op (the (tokens × vocab) logits
        never materialize on the kernel path) and then weighted, as in the
        reference; ``metrics`` holds ``ce_loss``, ``aux_loss`` (0 for the
        dense stack) and ``tokens`` (the mask's sum, at least 1).  An MoE
        model adds the router terms ``router_aux_coef · lb +
        router_entropy_coef · entropy deficit`` (both summed over its MoE
        layers) to the loss, and reports ``aux_loss`` (lb),
        ``router_entropy`` (the mean over layers), ``router_drop_frac`` and
        ``router_load`` (the per-expert kept-load fractions, (E,)), as the
        reference does.

        ``seq2seq`` (an encoder-decoder) is the ``clm`` loss of the decoder
        over the encoder output of ``src_tokens`` or ``enc_embeds``.  A
        vision model's stream is [image rows; text], and its loss is the
        text's: the first ``num_frontend_tokens`` rows are dropped, whether
        or not the batch has ``img_embeds``, as in the reference.

        On a mesh ``batch`` holds this rank's rows and ``params`` is the
        compute view (``compute_params``).  The loss is the global mean:
        the masked sum and the token count are summed over the ranks that
        hold other tokens (``ShardingCtx.reduce_axes``), and the sum's
        gradient is each rank's own part of it, so the gradients summed
        over those ranks are the global mean's.  Under context parallelism
        a rank takes its rows of the sequence first; a causal model's next
        token then comes from the whole row (the last row, which has none,
        weighs 0)."""
        cfg, ctx = self.cfg, self.ctx
        if ctx.seq_parallel:
            aux, hidden, targets, mask = self._seq_shard_rows(params, batch)
        else:
            x = self._decoder_input(params, batch["tokens"], img=batch.get("img_embeds"))
            x, _, aux = self._backbone(params, x, cross_kv=self._cross_kv(params, batch))
            B, S, D = x.shape
            if cfg.objective == "mlm":
                hidden = x.reshape(B * S, D)
                targets = batch["targets"].reshape(-1)
                mask = batch["loss_mask"].reshape(-1).float()
            else:  # clm / seq2seq / vlm: next-token over the text
                n_front = cfg.num_frontend_tokens if cfg.frontend == "vision_stub" else 0
                hidden = x[:, n_front:][:, :-1, :].reshape(-1, D)
                targets = batch["tokens"][:, 1:].reshape(-1)
                mask = batch.get("loss_mask")
                mask = (mask[:, 1:].reshape(-1).float() if mask is not None
                        else torch.ones(targets.shape, dtype=torch.float32, device=x.device))
        w_head = self.head_weight(params).to(self.policy.cdt)
        losses, _ = ops.cross_entropy(hidden, w_head, targets, vocab=cfg.vocab_size,
                                      impl=cfg.kernel_impl)
        num, den = (losses * mask).sum(), mask.sum()
        if self.sharded:
            num = ctx.reduce_sum(num, ctx.reduce_axes)
            den = ctx.all_reduce(den, ctx.reduce_axes)
        denom = den.clamp_min(1.0)
        loss = num / denom
        metrics = {"ce_loss": loss, "aux_loss": aux, "tokens": denom}
        if cfg.num_experts:
            # aux: the layer-summed router vector (moe.aux_shape) —
            # [lb, entropy deficit, dropped, slots, per-expert load…]
            lb, ent_def = aux[0], aux[1]
            loss = loss + cfg.router_aux_coef * lb + cfg.router_entropy_coef * ent_def
            n_moe = max(T.num_moe_layers(cfg), 1)
            load = aux[4:]
            metrics.update(aux_loss=lb,
                           router_entropy=math.log(float(cfg.num_experts)) - ent_def / n_moe,
                           router_drop_frac=aux[2] / aux[3].clamp_min(1.0),
                           router_load=load / load.sum().clamp_min(1e-9))
        return loss, metrics

    def _seq_shard_rows(self, params: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        """Context parallelism: the stack over this rank's rows of the
        sequence; returns (aux, hidden (B·n, D), targets, mask) of them."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        off, n = self.ctx.seq_chunk(S)
        pos = torch.arange(off, off + n, device=tokens.device)
        x = L.embed_apply(cfg, params["embed"], tokens[:, off:off + n], pos,
                          compute_dtype=self.policy.cdt)
        x, _, aux = self._backbone(params, x, positions=pos)
        if cfg.objective == "mlm":
            targets = batch["targets"][:, off:off + n]
            mask = batch["loss_mask"][:, off:off + n].float()
        else:
            pad = tokens.new_zeros((B, 1))
            targets = torch.cat([tokens[:, 1:], pad], dim=1)[:, off:off + n]
            m = batch.get("loss_mask")
            m = (m[:, 1:].float() if m is not None
                 else torch.ones((B, S - 1), dtype=torch.float32, device=tokens.device))
            mask = torch.cat([m, m.new_zeros((B, 1))], dim=1)[:, off:off + n]
        return aux, x.reshape(B * n, -1), targets.reshape(-1), mask.reshape(-1)

    # ------------------------------------------------------------ serving
    @torch.inference_mode()
    def embed_pool(self, tokens: torch.Tensor, lengths: torch.Tensor,
                   params: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        """Masked mean-pooled sequence embeddings: (B, S) tokens + (B,)
        valid lengths -> (B, d_model) float32.  ``params``: the serving view
        (default ``serving_params()``).

        Runs the full-sequence forward in train mode.  For bidirectional
        (MLM) models the pad tokens are visible to attention exactly as in
        training — no key-padding mask — and only positions < lengths[b]
        enter the fp32 mean, as in the reference.  On a mesh every rank
        returns the same rows: under head-TP the layers all-reduce over
        ``model``; under context parallelism a rank runs its rows of the
        sequence (``ShardingCtx.seq_chunk``; S must divide over ``model``)
        and the masked sums and counts are all-reduced over ``model``."""
        p = self.serving_params() if params is None else params
        ctx = self.ctx
        off, n = ctx.seq_chunk(tokens.shape[1])
        pos = torch.arange(off, off + n, device=tokens.device) if ctx.seq_parallel else None
        x = self._decoder_input(p, tokens[:, off:off + n], pos)
        x, _, _ = self._backbone(p, x, serving=True, positions=pos)
        rows = off + torch.arange(n, device=x.device)
        mask = rows[None, :] < lengths.to(x.device)[:, None]
        x = x.float() * mask[..., None]
        if not ctx.seq_parallel:
            denom = mask.sum(dim=1).clamp_min(1).float()
            return x.sum(dim=1) / denom[:, None]
        sums = ctx.all_reduce(x.sum(dim=1), ("model",))
        denom = ctx.all_reduce(mask.sum(dim=1).float(), ("model",)).clamp_min(1.0)
        return sums / denom[:, None]

    # ------------------------------------------------------------ generation
    @torch.no_grad()
    def prefill(self, params: Dict[str, Any], batch: Dict[str, torch.Tensor], max_len: int,
                *, length: Optional[int] = None) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Full-sequence forward -> (last logits (B, 1, Vpad), cache).

        ``length``: the number of valid tokens when the prompt is
        right-padded to a bucket (the engine's prompt bucketing); the logits
        then come from row ``length - 1`` and the cache position is
        ``length``.  Right padding is sound only for causal attention (pad
        rows lie in every real row's future); the engine gates it.  The
        cache is ``{"layers": stacked K/V placed in max_len (or rolling
        window) buffers, "pos": int}``.

        An encoder-decoder's batch carries ``src_tokens`` or ``enc_embeds``
        too, and each layer's cache its ``xattn`` K/V over the encoder
        output.  A vision model's ``img_embeds`` rows go in front of the
        text: ``length`` then counts them, as the cache position does."""
        self._check_generation()
        x = self._decoder_input(params, batch["tokens"], img=batch.get("img_embeds"))
        S = x.shape[1]
        x, caches, _ = self._backbone(params, x, serving=True, mode="prefill",
                                      cross_kv=self._cross_kv(params, batch))
        pos = S if length is None else int(length)
        lg = self.logits(params, x[:, pos - 1 : pos, :])
        return lg, {"layers": self._pad_caches(caches, S, max_len), "pos": pos}

    @torch.no_grad()
    def prefill_chunk(self, params: Dict[str, Any], layers: Dict[str, Any], tokens: torch.Tensor,
                      block_row: torch.Tensor, start: int, n_valid: int
                      ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One bounded chunk of an incremental prefill over the paged
        engine cache (prefix caching and chunked prefill).

        ``layers`` is the engine cache's ``"layers"`` tree (the shared page
        pools); ``tokens`` (1, C) is a chunk right-padded to a bucket;
        ``block_row`` (1, pages_per_seq) is the slot's row of the block
        table; ``start`` is the position of the chunk's first token (> 0
        when a cached prefix was skipped or an earlier chunk ran);
        ``n_valid`` (<= C) is the number of real rows.  The chunk's K/V rows
        go into the slot's pages in place, and attention runs causally over
        positions [0, start + n_valid) through the block table — pages
        shared from the prefix cache included.  Returns (logits (1, 1,
        Vpad) of the last valid row — meaningful on the final chunk —,
        layers).  Sound only for causal attention-only stacks; the engine
        gates it."""
        self._check_generation()
        C = tokens.shape[1]
        positions = start + torch.arange(C, device=tokens.device)
        x = self._decoder_input(params, tokens, positions)
        page = _page_size(layers)
        paged = A.paged_chunk_addressing(block_row, int(start), C, int(n_valid), page)
        x, layers, _ = self._backbone(params, x, serving=True, mode="chunk", positions=positions,
                                      caches=layers, cache_pos=int(start), paged=paged)
        return self.logits(params, x[:, n_valid - 1 : n_valid, :]), layers

    @torch.no_grad()
    def decode_step(self, params: Dict[str, Any], cache: Dict[str, Any], tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One-token step: tokens (B, 1) -> (logits (B, 1, Vpad), cache).
        ``cache["pos"]`` is an int (lockstep rows) or a (B,) tensor (the
        continuous-batching engine); the K/V buffers (or page pools, read
        and written through ``cache["block_table"]``) are updated in place
        and the returned cache holds them with ``pos + 1``."""
        self._check_generation()
        pos = cache["pos"]
        block_table = cache.get("block_table")
        paged = None
        if block_table is not None:     # the paging arithmetic, once for all layers
            page = _page_size(cache["layers"])
            paged = A.paged_decode_addressing(block_table, pos, page)
        per_slot = torch.is_tensor(pos)
        rope_pos = None if per_slot else torch.full((1,), int(pos), device=tokens.device)
        x = self._decoder_input(params, tokens, pos[:, None] if per_slot else rope_pos)
        x, layers, _ = self._backbone(params, x, serving=True, mode="decode",
                                      positions=rope_pos, caches=cache["layers"], cache_pos=pos,
                                      paged=paged)
        new = {"layers": layers, "pos": pos + 1}
        if block_table is not None:
            new["block_table"] = block_table
        return self.logits(params, x), new

    @torch.no_grad()
    def init_cache(self, batch: int, max_len: int, cross_len: int = 0, *, layout: str = "dense",
                   page_size: int = 0, num_pages: int = 0) -> Dict[str, Any]:
        """A zeroed decode cache in the compute dtype.  Dense: K/V buffers,
        position 0.  ``layout="paged"``: page pools shared by the slots, a
        top-level (batch, pages_per_seq) ``block_table`` of the null page 0
        that the engine's allocator maintains, and a per-slot (batch,)
        ``pos``.  An encoder-decoder with ``cross_len`` > 0 also gets each
        layer's dense per-slot cross cache (``T.init_stack_cache``).  On a
        mesh the K/V buffers and pools hold the rank's K/V heads
        (``rank_kv_heads``); the block table, ``pos`` and the cross cache
        are whole on every rank."""
        self._check_generation()
        kv = len(rank_kv_heads(self.cfg, self.ctx))
        if layout == "paged":
            if page_size <= 0 or num_pages <= 1:
                raise ValueError("paged layout needs page_size>0, num_pages>1")
            pages_per_seq = -(-max_len // page_size)
            dev = self.device
            return {"layers": T.init_stack_cache(self.cfg, batch, max_len, self.policy.cdt, dev,
                                                 cross_len=cross_len, layout="paged",
                                                 page_size=page_size, num_pages=num_pages,
                                                 kv_heads=kv),
                    "block_table": torch.zeros((batch, pages_per_seq), dtype=torch.int32,
                                               device=dev),
                    "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}
        return {"layers": T.init_stack_cache(self.cfg, batch, max_len, self.policy.cdt,
                                             self.device, cross_len=cross_len, kv_heads=kv),
                "pos": 0}

    def _pad_caches(self, caches: Dict[str, Any], S: int, max_len: int) -> Dict[str, Any]:
        """Place prefill K/V (S rows) into preallocated buffers of W = max_len
        rows (the window, if smaller): zero-padded when S <= W, else rolling
        — slot j holds token S - W + ((j - S) mod W), so the next write at
        S mod W overwrites the oldest.  An SSM layer's ``conv``/``state``
        have no sequence dim and a cross layer's ``xattn`` K/V keep their
        T_enc rows: both pass through as they are."""
        cfg = self.cfg
        W = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len

        def place(leaf):
            if S <= W:
                buf = leaf.new_zeros((*leaf.shape[:2], W, *leaf.shape[3:]))
                buf[:, :, :S] = leaf
                return buf
            slots = torch.arange(W, device=leaf.device)
            return leaf.index_select(2, S - W + (slots - S) % W)

        return {s: {kind: tree_map(place, c) if kind == "attn" else c for kind, c in sub.items()}
                for s, sub in caches.items()}


def _page_size(layers: Dict[str, Any]) -> int:
    """The page size of the paged pools (the same in every layer of the unit)."""
    return next(iter(layers.values()))["attn"]["k_pool"].shape[2]


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """The GPU unless the caller names another device; no silent CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU by default; pass "
                "device='cpu' to run on the CPU"
            )
        device = "cuda"
    return torch.device(device)


def build_model(cfg: ModelConfig, pc: Optional[ParallelConfig] = None, mesh: Any = None, *,
                device: Union[None, str, torch.device] = None, seed: int = 0) -> Model:
    """A model with seeded random weights on ``device`` (default: cuda),
    keeping ``pc`` (default ``ParallelConfig()``: remat ``block``).  On a
    ``mesh`` each leaf is drawn whole from its seed and only this rank's
    shard of it is kept, a leaf at a time: the mesh-free model's weights."""
    dev = resolve_device(device)
    pdt = policy_for(cfg).pdt
    if mesh is None:
        return Model(cfg, materialize(param_defs(cfg), seed, pdt, dev), pc)
    _, ctx, specs = _mesh_layout(cfg, pc or ParallelConfig(), mesh)
    keep = lambda path, leaf: ctx.shard(leaf, tree_get(specs, path).store)  # noqa: E731
    return Model(cfg, materialize(param_defs(cfg), seed, pdt, dev, keep=keep), pc, mesh)


def _mesh_layout(cfg: ModelConfig, pc: ParallelConfig, mesh: Any):
    """(pc validated for the ``model`` axis, its ShardingCtx, each leaf's
    LeafSpec) of a model on ``mesh``; raises for a family the ``model`` axis
    does not split."""
    tp = mesh_axis_sizes(mesh).get("model", 1)
    check_mesh_support(cfg, tp)
    pc = pc.validate(cfg, tp)
    ctx = ShardingCtx(mesh, pc)
    return pc, ctx, ctx.param_specs(param_defs(cfg), cfg)
