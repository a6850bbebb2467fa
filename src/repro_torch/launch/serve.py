"""Static-batch generation (the port's copy of the reference's
``launch/serve.py::generate``).

    model = build_model(get_config("molmim-65m"))          # on the GPU
    toks, tok_s = generate(model, None, {"tokens": prompts, "src_tokens": sources},
                           max_len=128, steps=64)

The path for the batches the serving engine does not admit: an
encoder-decoder whose encoder length is its source's (MolMIM), or a batch
in which every row has its own audio or image (``enc_embeds`` or
``img_embeds`` of B rows, where the engine holds one for all requests).
One ``Model.prefill`` of the whole batch, then one ``Model.decode_step`` a
token, each token picked on the device by ``ops.sample_tokens`` (the fused
sampler kernel on the card) with the reference's per-row seeds
``arange(B) + seed`` and generation index ``i``, so a sampled run draws the
reference's tokens.  It runs where the model is: ``build_model`` puts it on
the GPU unless the caller asks for the CPU.  The continuous-batching server
and the mesh half of the reference's launcher come with multi-GPU.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops


@torch.no_grad()
def generate(model, params: Optional[Dict[str, Any]], batch: Dict[str, Any], *, max_len: int,
             steps: int, temperature: float = 0.0, seed: int = 0, top_k: int = 0,
             top_p: float = 1.0) -> Tuple[torch.Tensor, float]:
    """Static-batch generation loop -> (tokens (B, steps) int32 on the
    model's device, generated tokens/s).

    ``params`` is the model's tree (None: its own); ``batch`` holds
    ``tokens`` (B, S) and what the model's prefill takes beside them
    (``src_tokens``, ``enc_embeds``, ``img_embeds``), numpy or tensors,
    moved to the model's device.  Step ``i`` picks row b's token with
    seed ``b + seed`` (mod 2^32) at generation index ``i``; greedy when
    ``temperature`` <= 0.  The cache holds ``max_len`` rows."""
    params = model.params.tree() if params is None else params
    dev = model.device
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    B = batch["tokens"].shape[0]
    impl = model.cfg.kernel_impl
    seeds = (np.arange(B, dtype=np.uint32) + np.uint32(seed & 0xFFFFFFFF)).view(np.int32)
    samp = (torch.full((B,), temperature, dtype=torch.float32, device=dev),
            torch.full((B,), top_k, dtype=torch.int32, device=dev),
            torch.full((B,), top_p, dtype=torch.float32, device=dev),
            torch.as_tensor(seeds, device=dev))
    logits, cache = model.prefill(params, batch, max_len)
    outs = []
    t0 = time.perf_counter()
    for i in range(steps):
        gen = torch.full((B,), i, dtype=torch.int32, device=dev)
        tok, _ = ops.sample_tokens(logits[:, -1], *samp, gen, impl=impl)
        outs.append(tok)
        logits, cache = model.decode_step(params, cache, tok[:, None])
    toks = torch.stack(outs, dim=1)
    if toks.is_cuda:
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    return toks, toks.numel() / dt
