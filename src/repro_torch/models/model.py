"""Top-level model: the param tree as an ``nn.Module`` plus the entry points
ported so far — embedding extraction, the training loss, and generation
over a dense or a paged KV cache (``prefill``, ``prefill_chunk``,
``decode_step``, ``init_cache``), for attention, SSM and hybrid stacks.

``build_model(cfg)`` materializes seeded random weights on the GPU; pass
``device="cpu"`` to run on the CPU (the tests do).  Weights from the
reference package cross in through ``checkpoint/bridge.py``:
``Model(cfg, from_jax_params(tree))``.  ``loss_fn(params, batch)`` takes the
param tree explicitly, as the reference's does, so the train step can run
it on the compute-dtype view of its master copy; the serving entry points
take it too.  To serve, build the model with bf16 parameters
(``dataclasses.replace(cfg, param_dtype="bfloat16")``): each weight's cast
to the compute dtype is then a no-op, instead of a re-read and re-cast of
the fp32 master copy in every decode step.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.core.config import ModelConfig
from repro_torch.core.module import ParamTree, materialize, tree_map
from repro_torch.core.precision import policy_for
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def param_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """The reference's param tree for the stacks the port runs."""
    return {
        "embed": L.embedding_defs(cfg),
        "layers": T.stack_defs(cfg),
        "final_norm": L.norm_defs(cfg, cfg.d_model),
        "head": L.lm_head_defs(cfg),
    }


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, params: Dict[str, Any]):
        super().__init__()
        T.check_supported(cfg)
        self.cfg = cfg
        self.policy = policy_for(cfg)
        self.params = ParamTree(params)

    @property
    def device(self) -> torch.device:
        return self.params.embed.tok.device

    # ------------------------------------------------------------ backbone
    def _decoder_input(self, params: Dict[str, Any], tokens: torch.Tensor) -> torch.Tensor:
        return L.embed_apply(self.cfg, params["embed"], tokens, compute_dtype=self.policy.cdt)

    def _backbone(self, params: Dict[str, Any], x: torch.Tensor, **kw):
        """The stack (train mode unless ``kw`` says otherwise), then the
        final norm; returns (x, caches, aux_sum) — aux_sum the MoE layers'
        router vectors summed (``moe.aux_shape``)."""
        x, caches, aux = T.decoder_stack(self.cfg, params["layers"], x, **kw)
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
        reference does."""
        cfg = self.cfg
        x, _, aux = self._backbone(params, self._decoder_input(params, batch["tokens"]))
        B, S, D = x.shape
        if cfg.objective == "mlm":
            hidden = x.reshape(B * S, D)
            targets = batch["targets"].reshape(-1)
            mask = batch["loss_mask"].reshape(-1).float()
        else:  # clm: next-token over the sequence
            hidden = x[:, :-1, :].reshape(-1, D)
            targets = batch["tokens"][:, 1:].reshape(-1)
            mask = batch.get("loss_mask")
            mask = (mask[:, 1:].reshape(-1).float() if mask is not None
                    else torch.ones(targets.shape, dtype=torch.float32, device=x.device))
        w_head = self.head_weight(params).to(self.policy.cdt)
        losses, _ = ops.cross_entropy(hidden, w_head, targets, vocab=cfg.vocab_size,
                                      impl=cfg.kernel_impl)
        denom = mask.sum().clamp_min(1.0)
        loss = (losses * mask).sum() / denom
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

    # ------------------------------------------------------------ serving
    @torch.inference_mode()
    def embed_pool(self, tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """Masked mean-pooled sequence embeddings: (B, S) tokens + (B,)
        valid lengths -> (B, d_model) float32.

        Runs the full-sequence forward in train mode.  For bidirectional
        (MLM) models the pad tokens are visible to attention exactly as in
        training — no key-padding mask — and only positions < lengths[b]
        enter the fp32 mean, as in the reference."""
        p = self.params.tree()
        x, _, _ = self._backbone(p, self._decoder_input(p, tokens))
        mask = torch.arange(x.shape[1], device=x.device)[None, :] < lengths.to(x.device)[:, None]
        x = x.float() * mask[..., None]
        denom = mask.sum(dim=1).clamp_min(1).float()
        return x.sum(dim=1) / denom[:, None]


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
        window) buffers, "pos": int}``."""
        x = self._decoder_input(params, batch["tokens"])
        S = x.shape[1]
        x, caches, _ = self._backbone(params, x, mode="prefill")
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
        C = tokens.shape[1]
        x = self._decoder_input(params, tokens)
        positions = start + torch.arange(C, device=x.device)
        page = _page_size(layers)
        paged = A.paged_chunk_addressing(block_row, int(start), C, int(n_valid), page)
        x, layers, _ = self._backbone(params, x, mode="chunk", positions=positions, caches=layers,
                                   cache_pos=int(start), paged=paged)
        return self.logits(params, x[:, n_valid - 1 : n_valid, :]), layers

    @torch.no_grad()
    def decode_step(self, params: Dict[str, Any], cache: Dict[str, Any], tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One-token step: tokens (B, 1) -> (logits (B, 1, Vpad), cache).
        ``cache["pos"]`` is an int (lockstep rows) or a (B,) tensor (the
        continuous-batching engine); the K/V buffers (or page pools, read
        and written through ``cache["block_table"]``) are updated in place
        and the returned cache holds them with ``pos + 1``."""
        pos = cache["pos"]
        block_table = cache.get("block_table")
        paged = None
        if block_table is not None:     # the paging arithmetic, once for all layers
            page = _page_size(cache["layers"])
            paged = A.paged_decode_addressing(block_table, pos, page)
        x = self._decoder_input(params, tokens)
        rope_pos = None if torch.is_tensor(pos) else torch.full((1,), int(pos), device=x.device)
        x, layers, _ = self._backbone(params, x, mode="decode", positions=rope_pos,
                                   caches=cache["layers"], cache_pos=pos, paged=paged)
        new = {"layers": layers, "pos": pos + 1}
        if block_table is not None:
            new["block_table"] = block_table
        return self.logits(params, x), new

    @torch.no_grad()
    def init_cache(self, batch: int, max_len: int, *, layout: str = "dense", page_size: int = 0,
                   num_pages: int = 0) -> Dict[str, Any]:
        """A zeroed decode cache in the compute dtype.  Dense: K/V buffers,
        position 0.  ``layout="paged"``: page pools shared by the slots, a
        top-level (batch, pages_per_seq) ``block_table`` of the null page 0
        that the engine's allocator maintains, and a per-slot (batch,)
        ``pos``."""
        if layout == "paged":
            if page_size <= 0 or num_pages <= 1:
                raise ValueError("paged layout needs page_size>0, num_pages>1")
            pages_per_seq = -(-max_len // page_size)
            dev = self.device
            return {"layers": T.init_stack_cache(self.cfg, batch, max_len, self.policy.cdt, dev,
                                                 layout="paged", page_size=page_size,
                                                 num_pages=num_pages),
                    "block_table": torch.zeros((batch, pages_per_seq), dtype=torch.int32,
                                               device=dev),
                    "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}
        return {"layers": T.init_stack_cache(self.cfg, batch, max_len, self.policy.cdt,
                                             self.device),
                "pos": 0}

    def _pad_caches(self, caches: Dict[str, Any], S: int, max_len: int) -> Dict[str, Any]:
        """Place prefill K/V (S rows) into preallocated buffers of W = max_len
        rows (the window, if smaller): zero-padded when S <= W, else rolling
        — slot j holds token S - W + ((j - S) mod W), so the next write at
        S mod W overwrites the oldest.  An SSM layer's ``conv``/``state``
        have no sequence dim and pass through as they are."""
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


def build_model(cfg: ModelConfig, *, device: Union[None, str, torch.device] = None,
                seed: int = 0) -> Model:
    """A model with seeded random weights on ``device`` (default: cuda)."""
    dev = resolve_device(device)
    return Model(cfg, materialize(param_defs(cfg), seed, policy_for(cfg).pdt, dev))
