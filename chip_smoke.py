#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's kernels from the sources in this checkout and holds each
of the fourteen kernels against its plain PyTorch version on the card.
Then drives the seven paths ported so far: embedding serving through
``LLM.embed`` and MLM pre-training through ``Trainer.run`` (about 10
optimizer steps) at the full width and depth of ESM-2 650M; generation
through ``LLM.generate`` at the full width and depth of Qwen2-7B (bf16
parameters, 32 slots, 64 prompts of 256 new tokens) over a dense
2048-token cache, then over the paged cache with prefix caching and
512-token chunked prefill (half the prompts behind one shared 512-token
preamble); and MoE generation through ``LLM.generate`` with
Llama-4-Scout at full width, its depth cut to 8 of 48 layers, on the same
load over the dense cache; and SSM generation through ``LLM.generate``
at the full width and depth of Mamba2-2.7B on the same load (ids within
its vocab), then the hybrid unit of Jamba-1.5-Large at ``reduced()`` size;
and MoE training through ``Trainer.run`` with Llama-4-Scout at full width,
1 of 48 layers (fp32 master weights, bf16 AdamW moments, 6 steps of 2 x
1024 packed protein tokens); all with seeded random weights, checking what
comes out of each.  Prints per-kernel times beside their bounds, the
embedding throughput, the training step time, tokens/s, MFU and peak
memory, the generation tokens/s, TTFT, decode-step time and idle share, the
router's drops, a profile of each path, then one JSON line of kernel
records and, last, ``{"ok": true, "device": {...}}``.  Exits non-zero,
printing no result, when there is no CUDA device or a phase fails.
Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12          # outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
AMINO_ACIDS = "ACDEFGHIKLMNPQRSTVWY"


def time_ms(torch, fn, trials: int = 20, per_trial: int = 10, warmup: int = 3) -> float:
    """Median over ``trials`` of the mean time of ``per_trial`` back-to-back
    calls of ``fn``, timed with CUDA events.  Back-to-back calls keep the
    host's launch latency off the device's clock."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per_trial):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_trial)
    return statistics.median(times)


def device_ms(torch, fn, *names: str, n: int = 20):
    """Device time of one call of ``fn``: the summed time of the kernels
    whose name holds one of ``names`` in a torch.profiler window of ``n``
    back-to-back calls, over ``n``.  Unlike ``time_ms`` it leaves out the
    host's launch path, which a small kernel can take longer than to run.
    A window that records none of the kernels (the profiler has dropped a
    window's device records) is taken again, up to three times; then the
    time is None: not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and any(m in e.key.lower() for m in names))
        if us > 0:
            return us / 1e3 / n
    return None


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def per_device_ms(amount: float, ms, unit: str, scale: float) -> str:
    """``amount`` over a device time as a rate, or "not measured"."""
    return f"{amount / ms / scale:.1f} {unit} on the device" if ms else "device rate not measured"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    """(least time in ms, what bounds it) for work of ``flops`` operations
    moving ``nbytes`` bytes."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def rel_err(got, want) -> float:
    """max |got - want| over max |want|, in fp32."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-30)).item()


def row_rel_err(got, want, dims: int = 1) -> float:
    """The largest over the rows (the first ``dims`` axes) of max |got_r -
    want_r| over max |want_r|, in fp32: each row held to its own scale, so
    that a row of large values (one that attends to a single key) does not
    cover errors in the others.  A row that should be all 0 must be exactly
    0 (its error is then 0, else about 1e30)."""
    g, w = got.float().flatten(0, dims - 1).flatten(1), want.float().flatten(0, dims - 1).flatten(1)
    return ((g - w).abs().amax(1) / w.abs().amax(1).clamp_min(1e-30)).max().item()


def kernel_groups(prof, DeviceType):
    """Device time by group from a torch.profiler run: (busy ms, {group: ms},
    [(name, ms, count)]).  CPU ops report their kernels' time too, so only
    device-side entries count; "Command Buffer Full" marks the host waiting
    on a full launch queue, and the engine's named scopes (``engine/...``,
    ``obs.profile.annotate``) span kernels counted already."""
    kern = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and "Command Buffer Full" not in e.key and not e.key.startswith("engine/")]
    groups = {"flash_attention_fwd": 0.0, "flash_attention_bwd": 0.0, "cross_entropy_fwd": 0.0,
              "cross_entropy_bwd": 0.0, "layernorm": 0.0, "rmsnorm": 0.0, "flash_decode": 0.0,
              "fused_sample": 0.0, "paged_decode": 0.0, "paged_prefill": 0.0,
              "paged_kv_write": 0.0, "gmm": 0.0, "gmm_dw": 0.0, "ssd_scan": 0.0, "matmul": 0.0,
              "other": 0.0}
    for name, t, _ in kern:
        low = name.lower()
        paged = [g for g in ("paged_decode", "paged_prefill", "paged_kv_write") if g in low]
        if paged:
            groups[paged[0]] += t
        elif "flash_attention_fwd" in low:
            groups["flash_attention_fwd"] += t
        elif any(w in low for w in ("dq_kernel", "dkv_kernel", "delta_kernel")):
            groups["flash_attention_bwd"] += t
        elif "ce_fwd_kernel" in low:
            groups["cross_entropy_fwd"] += t
        elif any(w in low for w in ("ce_dh_kernel", "ce_dw_kernel", "ce_dw_sum_kernel")):
            groups["cross_entropy_bwd"] += t
        elif "layernorm" in low:
            groups["layernorm"] += t
        elif "rmsnorm" in low:
            groups["rmsnorm"] += t
        elif "flash_decode" in low:
            groups["flash_decode"] += t
        elif "gmm_dw_kernel" in low:
            groups["gmm_dw"] += t
        elif "gmm_kernel" in low:
            groups["gmm"] += t
        elif "ssd_scan_kernel" in low:
            groups["ssd_scan"] += t
        elif "fused_sample" in low:
            groups["fused_sample"] += t
        elif any(w in low for w in ("gemm", "xmma", "cutlass", "nvjet")):
            groups["matmul"] += t
        else:
            groups["other"] += t
    return sum(t for _, t, _ in kern), groups, kern


def cosine(torch, a, b, chunk: int = 1 << 24) -> float:
    """Cosine of two tensors' flattened values, summed in fp64 a chunk at a
    time (a whole fp64 copy of a 1 G-element leaf would take 8 GB)."""
    a, b = a.reshape(-1), b.reshape(-1)
    ab = aa = bb = torch.zeros((), dtype=torch.float64, device=a.device)
    for i in range(0, a.numel(), chunk):
        x, y = a[i:i + chunk].double(), b[i:i + chunk].double()
        ab, aa, bb = ab + (x * y).sum(), aa + (x * x).sum(), bb + (y * y).sum()
    return (ab / (aa.sqrt() * bb.sqrt()).clamp_min(1e-300)).item()


def leaf_paths(tree, prefix=""):
    """Paths of a nested dict's leaves in sorted-key order (``tree_leaves``'s)."""
    return [n for k in sorted(tree) for n in (
        leaf_paths(tree[k], f"{prefix}{k}/") if isinstance(tree[k], dict) else [prefix + k])]


def check_attention_bwd(torch, F, ref, flash_attention_fwd, flash_attention_bwd, randn, card):
    """Row 2 against ``attention_bwd_ref``; times it at the ESM-2 training
    shape.  Returns its kernel record (launches filled in later)."""
    # tolerance relative to max|ref| per gradient: the kernel rounds P and
    # dS to the input dtype before the three products that take them (at
    # most 2^-9 relative per element in bf16, 2^-12 in fp16) where the
    # plain version keeps fp32; the gradients are rounded once in both
    tol = {torch.bfloat16: 2e-2, torch.float16: 4e-3}
    cases = [
        ("esm2-650m training shape", dict(B=8, S=1024, T=1024, H=20, Hkv=20, D=64), dict(causal=False)),
        ("causal", dict(B=2, S=128, T=128, H=4, Hkv=4, D=64), dict(causal=True)),
        ("causal window", dict(B=2, S=200, T=200, H=4, Hkv=4, D=64), dict(causal=True, window=48)),
        ("softcap", dict(B=2, S=96, T=96, H=4, Hkv=4, D=64), dict(causal=False, softcap=20.0)),
        ("gqa H=8 Hkv=2", dict(B=2, S=128, T=128, H=8, Hkv=2, D=64), dict(causal=True)),
        ("D=128", dict(B=2, S=128, T=128, H=4, Hkv=4, D=128), dict(causal=False)),
        ("non-multiple S/T", dict(B=3, S=77, T=131, H=4, Hkv=4, D=64), dict(causal=False)),
        ("q_offset", dict(B=2, S=40, T=104, H=4, Hkv=2, D=128), dict(causal=True, q_offset=64)),
        ("fully-masked rows", dict(B=1, S=24, T=24, H=2, Hkv=2, D=64), dict(causal=True, q_offset=-8)),
    ]
    first_err = 0.0
    for label, s, kw in cases:
        for dt in (torch.bfloat16, torch.float16):
            q = randn(s["B"], s["S"], s["H"], s["D"], dtype=dt)
            k = randn(s["B"], s["T"], s["Hkv"], s["D"], dtype=dt)
            v = randn(s["B"], s["T"], s["Hkv"], s["D"], dtype=dt)
            do = randn(s["B"], s["S"], s["H"], s["D"], dtype=dt)
            out, lse = flash_attention_fwd(q, k, v, **kw)
            got = flash_attention_bwd(q, k, v, out, lse, do, **kw)
            torch.cuda.synchronize()
            want = ref.attention_bwd_ref(q, k, v, out, lse, do, **kw)
            errs = [rel_err(g, w) for g, w in zip(got, want)]
            finite = all(bool(g.isfinite().all()) for g in got)
            print(f"flash_attention_bwd {label} {str(dt)[6:]}: rel err dq {errs[0]:.3g} "
                  f"dk {errs[1]:.3g} dv {errs[2]:.3g} (tol {tol[dt]} of max|ref|)")
            check(finite and max(errs) <= tol[dt], f"flash_attention_bwd {label} {dt}")
            if label.startswith("fully-masked"):
                check(bool((got[0][:, :8] == 0).all()), "fully-masked rows: dq is not zero")
            if label.startswith("esm2") and dt == torch.bfloat16:
                first_err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))

    B, S, H, D = 8, 1024, 20, 64
    q, k, v, do = (randn(B, S, H, D) for _ in range(4))
    out, lse = flash_attention_fwd(q, k, v, causal=False)
    ms = time_ms(torch, lambda: flash_attention_bwd(q, k, v, out, lse, do, causal=False))
    dev_ms = device_ms(torch, lambda: flash_attention_bwd(q, k, v, out, lse, do, causal=False),
                       "dq_kernel", "dkv_kernel", "delta_kernel")
    plain_ms = time_ms(torch, lambda: ref.attention_bwd_ref(q, k, v, out, lse, do, causal=False),
                       trials=5, per_trial=2)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt)
    dot = do.transpose(1, 2).contiguous()
    lib_ms = time_ms(torch, lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True))
    # 5 products of 2*B*H*S*T*D each (QK^T and dO V^T in both passes, dQ,
    # dK, dV); bytes: q, k, v, out, dO, lse read, dq, dk, dv written
    bound_ms, bound_by = bound(10 * B * H * S * S * D, 8 * B * S * H * D * 2 + B * H * S * 4)
    print(f"flash_attention_bwd B={B} S=T={S} H={H} D={D} bf16 on {card}: {ms:.4f} ms "
          f"(device {fmt_ms(dev_ms)} ms) "
          f"(bound {bound_ms:.4f} ms by {bound_by}, {10 * B * H * S * S * D / ms / 1e9:.1f} TFLOP/s), "
          f"plain {plain_ms:.4f} ms, scaled_dot_product_attention backward {lib_ms:.4f} ms")
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention.py:451",
            "launches": 0, "max_abs_err": first_err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}


def check_cross_entropy(torch, F, ref, cross_entropy_fwd, cross_entropy_bwd, randn, g, card):
    """Rows 3 and 4 against their plain versions; times them at the ESM-2
    training shape.  Returns their kernel records."""
    dev = torch.device("cuda")
    # loss/lse: fp32 logits of the same products summed in another order;
    # dh/dw: the kernel rounds dlogits to bf16 before the two products
    # (2^-9 relative per element) where the plain version keeps fp32
    loss_tol, grad_tol = 2e-4, 2e-2
    cases = [
        ("esm2-650m tied head", dict(T=8192, D=1280, Vp=256, vocab=33, tied=True)),
        ("ragged T, untied head", dict(T=1000, D=1280, Vp=256, vocab=33, tied=False)),
        ("Vpad 32768, 512 vocab tiles", dict(T=2048, D=1280, Vp=32768, vocab=32000, tied=True)),
    ]
    errs0 = {}
    for label, c in cases:
        T, D, Vp, vocab = c["T"], c["D"], c["Vp"], c["vocab"]
        h = randn(T, D)
        w = randn(Vp, D, scale=0.05).T if c["tied"] else randn(D, Vp, scale=0.05)
        tgt = torch.randint(0, vocab, (T,), device=dev, generator=g, dtype=torch.int32)
        gl = torch.rand(T, device=dev, generator=g) / T
        gs = torch.rand(T, device=dev, generator=g) * (0.1 / T)     # a nonzero lse cotangent
        loss, lse = cross_entropy_fwd(h, w, tgt, vocab=vocab)
        dh, dw = cross_entropy_bwd(h, w, tgt, lse, gl, gs, vocab=vocab)
        torch.cuda.synchronize()
        r_loss, r_lse = ref.cross_entropy_ref(h, w, tgt, vocab)
        r_dh, r_dw = ref.cross_entropy_bwd_ref(h, w, tgt, r_lse, gl, gs, vocab)
        e_loss = max((loss - r_loss).abs().max().item(), (lse - r_lse).abs().max().item())
        e_dh, e_dw = rel_err(dh, r_dh), rel_err(dw, r_dw)
        pad_zero = bool((dw[:, vocab:] == 0).all())
        print(f"cross_entropy {label} (T={T}, D={D}, Vpad={Vp}, vocab={vocab}): loss/lse err "
              f"{e_loss:.3g} (tol {loss_tol}), dh {e_dh:.3g}, dw {e_dw:.3g} (tol {grad_tol} of "
              f"max|ref|), padded dw columns exactly 0: {pad_zero}")
        check(e_loss <= loss_tol and bool(loss.isfinite().all()), f"cross_entropy_fwd {label}")
        check(e_dh <= grad_tol and e_dw <= grad_tol and pad_zero, f"cross_entropy_bwd {label}")
        if not errs0:
            errs0 = {"fwd": e_loss, "bwd": max((dh.float() - r_dh.float()).abs().max().item(),
                                               (dw.float() - r_dw.float()).abs().max().item())}

    T, D, Vp, vocab = 8192, 1280, 256, 33
    h = randn(T, D)
    w = randn(Vp, D, scale=0.05).T
    tgt = torch.randint(0, vocab, (T,), device=dev, generator=g, dtype=torch.int32)
    gl = torch.full((T,), 1.0 / T, device=dev)
    gs = torch.zeros(T, device=dev)
    loss, lse = cross_entropy_fwd(h, w, tgt, vocab=vocab)
    fwd_ms = time_ms(torch, lambda: cross_entropy_fwd(h, w, tgt, vocab=vocab))
    bwd_ms = time_ms(torch, lambda: cross_entropy_bwd(h, w, tgt, lse, gl, gs, vocab=vocab))
    fwd_dev = device_ms(torch, lambda: cross_entropy_fwd(h, w, tgt, vocab=vocab), "ce_fwd_kernel")
    bwd_dev = device_ms(torch, lambda: cross_entropy_bwd(h, w, tgt, lse, gl, gs, vocab=vocab),
                        "ce_dh_kernel", "ce_dw_kernel", "ce_dw_sum_kernel")
    fwd_plain = time_ms(torch, lambda: ref.cross_entropy_ref(h, w, tgt, vocab), trials=5, per_trial=5)
    bwd_plain = time_ms(torch, lambda: ref.cross_entropy_bwd_ref(h, w, tgt, lse, gl, gs, vocab),
                        trials=5, per_trial=5)
    hl = h.clone().requires_grad_(True)
    wl = w[:, :vocab].clone().requires_grad_(True)
    tl = tgt.long()
    fwd_lib = time_ms(torch, lambda: F.cross_entropy((hl @ wl).float(), tl, reduction="none"))
    lib_loss = F.cross_entropy((hl @ wl).float(), tl, reduction="none")
    bwd_lib = time_ms(torch, lambda: torch.autograd.grad(lib_loss, (hl, wl), gl, retain_graph=True))
    # only the work the function needs: the `vocab` live columns of W (the
    # padded ones give no output but dW's zeros).  Forward: h and W's live
    # columns read, targets read, loss and lse written.  Backward: the same
    # reads plus lse and the two cotangents, dh written and dW written whole
    reads = T * D * 2 + D * vocab * 2 + T * 4
    fwd_bound, fwd_by = bound(2 * T * D * vocab, reads + 2 * T * 4)
    bwd_bound, bwd_by = bound(6 * T * D * vocab, reads + 3 * T * 4 + T * D * 2 + D * Vp * 2)
    print(f"cross_entropy_fwd T={T} D={D} Vpad={Vp} bf16 on {card}: {fwd_ms:.4f} ms (device "
          f"{fmt_ms(fwd_dev)} ms; bound "
          f"{fwd_bound:.4f} ms by {fwd_by}), plain {fwd_plain:.4f} ms, F.cross_entropy(h @ W) "
          f"{fwd_lib:.4f} ms")
    print(f"cross_entropy_bwd T={T} D={D} Vpad={Vp} bf16 on {card}: {bwd_ms:.4f} ms (device "
          f"{fmt_ms(bwd_dev)} ms; bound "
          f"{bwd_bound:.4f} ms by {bwd_by}), plain {bwd_plain:.4f} ms, F.cross_entropy(h @ W) "
          f"backward {bwd_lib:.4f} ms")
    rec = {"route": "cuda", "source": "src/repro_torch/kernels/csrc/cross_entropy.cu", "launches": 0}
    return [
        dict(rec, name="cross_entropy_fwd", replaces="src/repro/kernels/cross_entropy.py:120",
             max_abs_err=errs0["fwd"], ms=fwd_ms, device_ms=fwd_dev, plain_ms=fwd_plain, bound_ms=fwd_bound,
             bound_by=fwd_by, library_ms=fwd_lib),
        dict(rec, name="cross_entropy_bwd", replaces="src/repro/kernels/cross_entropy.py:266",
             max_abs_err=errs0["bwd"], ms=bwd_ms, device_ms=bwd_dev, plain_ms=bwd_plain, bound_ms=bwd_bound,
             bound_by=bwd_by, library_ms=bwd_lib),
    ]


def train_phase(torch, model, counters, card):
    """The slice: ESM-2 650M MLM pre-training through ``Trainer.run`` at full
    width and depth; returns the launch counts of its run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.config import TrainConfig
    from repro_torch.core.module import tree_leaves
    from repro_torch.core.precision import compute_view
    from repro_torch.data.dataset import build_synthetic_protein_memmap
    from repro_torch.data.pipeline import MLMBatches
    from repro_torch.data.sampler import ClusterSampler, greedy_length_clusters
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.training.loop import Trainer
    from repro_torch.training.train_step import make_train_step

    cfg = model.cfg
    micro, seq, accum, steps = 8, 1024, 2, 10
    tc = TrainConfig(global_batch=micro * accum, seq_len=seq, accum_steps=accum,
                     learning_rate=1e-4, min_lr=1e-5, warmup_steps=2, decay_steps=3,
                     total_steps=steps, schedule="wsd", weight_decay=0.01, beta2=0.98,
                     grad_clip=1.0, log_every=steps)
    tmp = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    ds, tok = build_synthetic_protein_memmap(f"{tmp.name}/prot", n=1024, seed=0,
                                             min_len=100, max_len=1023)
    sampler = ClusterSampler(greedy_length_clusters(ds.lengths(), 64), seed=0)
    pipe = MLMBatches(ds, tok, sampler, tc.global_batch, seq, mask_prob=cfg.mlm_mask_prob, seed=0)
    drawn = []

    def counted():
        for b in pipe:
            drawn.append(int((b["targets"] != tok.pad_id).sum()))
            yield b

    print(f"training data: {len(ds)} synthetic sequences of 100-1022 residues in "
          f"{time.perf_counter() - t0:.1f} s; micro-batch {micro}x{seq}, accum {accum} "
          f"({micro * accum * seq} tokens a step), AdamW + WSD, peak lr {tc.learning_rate}, "
          f"{steps} steps")

    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(model, tc, peak_flops=PEAK_BF16_FLOPS)
    state, hist = trainer.run(counted())
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_micro, L = steps * accum, cfg.num_layers
    want = {"flash_attention_fwd": L * n_micro, "flash_attention_bwd": L * n_micro,
            "layernorm": (2 * L + 1) * n_micro, "cross_entropy_fwd": n_micro,
            "cross_entropy_bwd": n_micro}
    print(f"main path: Trainer.run of {steps} steps x {accum} micro-batches: launches {launches} "
          f"(want {want})")
    # log_every = steps: the trainer flushes after step 0 and after the last
    # step, so steps 1 to the last run as one window with one host transfer
    losses = [h["loss"] for h in hist]
    print(f"losses: step 0 {losses[0]:.4f}, step {steps - 1} {losses[-1]:.4f}")
    # every check of this phase runs and reports before the phase fails
    failed = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    expect(len(hist) == 2 and all(x == x and abs(x) < 1e30 for x in losses), "non-finite loss")
    # a step with a non-finite loss or grad norm is skipped and counted
    expect(trainer.skipped_total == 0, f"{trainer.skipped_total} skipped steps")
    expect(losses[-1] < losses[0], "the loss did not fall")
    expect(launches == want, "training launch counts")

    step_s = hist[-1]["step_time"]
    padded = micro * accum * seq
    real = statistics.mean(drawn) if drawn else 0.0
    mfu = 6 * cfg.active_param_count() * padded / step_s / PEAK_BF16_FLOPS
    print(f"ESM-2 650M MLM training on {card}: step {step_s * 1e3:.1f} ms (wall of steps 1-"
          f"{steps - 1} over {steps - 1}, one host transfer; step 0 with its transfer "
          f"{hist[0]['step_time'] * 1e3:.1f} ms), {real / step_s:.0f} "
          f"real tokens/s, {padded / step_s:.0f} padded tokens/s, MFU {mfu:.4f} "
          f"(6 x {cfg.active_param_count() / 1e6:.0f}M params x padded tokens / 989 TFLOP/s), "
          f"peak memory {peak_gb:.2f} GB")

    # where the time goes: one more optimizer step under the profiler
    batch = {k: torch.from_numpy(v).to(model.device) for k, v in next(iter(pipe)).items()}
    step_fn = make_train_step(model, tc)
    step_fn(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, groups, kern = kernel_groups(prof, DeviceType)
    params = state.params
    leaves = tree_leaves(params)
    grads = [torch.zeros_like(p) for p in leaves]
    never = torch.zeros((), dtype=torch.bool, device=leaves[0].device)
    opt_ms = time_ms(torch, lambda: adamw.apply_updates(
        params, adamw.clip_by_global_norm(grads, 1.0)[0], state.opt, never.float(),
        tc, ok=never), trials=5, per_trial=2, warmup=1)
    del grads
    if busy_ms == 0:
        print("profile: the profiler saw no device time")
    else:
        print(f"profile of one train step on {card}: wall {wall_ms:.1f} ms (under the profiler), "
              f"device busy {busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
        print("profile by group: " + ", ".join(
            f"{k} {v:.1f} ms ({v / busy_ms:.1%})" for k, v in groups.items()))
        for name, t, cnt in sorted(kern, key=lambda r: -r[1])[:14]:
            print(f"  {t:9.2f} ms {cnt:6d}x  {name[:110]}")
    print(f"optimizer (global-norm clip + AdamW over {sum(p.numel() for p in leaves) / 1e6:.0f}M "
          f"fp32 params, part of 'other' above) on {card}: {opt_ms:.1f} ms")

    # one step repeated from the same state and batch: the same bits
    one = make_train_step(model, dataclasses.replace(tc, accum_steps=1))
    mb = {k: v[:micro] for k, v in batch.items()}
    first = trainer.state.clone()
    again = first.clone()
    first, _ = one(first, mb)
    again, _ = one(again, mb)
    torch.cuda.synchronize()
    a_leaves = tree_leaves(first.params) + tree_leaves(first.opt.mu) + tree_leaves(first.opt.nu)
    b_leaves = tree_leaves(again.params) + tree_leaves(again.opt.mu) + tree_leaves(again.opt.nu)
    differ = [i for i, (x, y) in enumerate(zip(a_leaves, b_leaves)) if not torch.equal(x, y)]
    print(f"one step repeated from the same state and batch: {len(differ)} of {len(a_leaves)} "
          f"state leaves differ {differ[:8]}")
    expect(not differ, "a repeated train step is not bit-identical")
    del first, again, a_leaves, b_leaves

    # the kernel path against the plain path: loss and every grad leaf at
    # full width and depth on a 2 x 512 batch
    small = {k: v[:2, :512].contiguous() for k, v in mb.items()}
    plain_model = Model(dataclasses.replace(cfg, kernel_impl="torch"), params)

    def loss_grads(m):
        p = m.params.tree()
        loss, _ = m.loss_fn(compute_view(m.policy, p), small)
        return loss.item(), torch.autograd.grad(loss, tree_leaves(p))

    k_loss, k_grads = loss_grads(model)
    p_loss, p_grads = loss_grads(plain_model)
    cos = [cosine(torch, a, b) for a, b in zip(k_grads, p_grads)]
    names = leaf_paths(params)
    worst = min(range(len(cos)), key=lambda i: cos[i])
    print(f"kernel path vs plain path (loss_fn + backward, 2x512): loss {k_loss:.6f} vs "
          f"{p_loss:.6f} (|diff| {abs(k_loss - p_loss):.3g}, tol 2e-2); grad cosine min "
          f"{cos[worst]:.6f} ({names[worst]}, of {len(cos)} leaves; floor 0.999), mean "
          f"{statistics.mean(cos):.6f}")
    print("lowest grad cosines: " + ", ".join(
        f"{names[i]} {cos[i]:.6f}" for i in sorted(range(len(cos)), key=lambda i: cos[i])[:5]))
    expect(abs(k_loss - p_loss) <= 2e-2, "kernel path loss disagrees with the plain path")
    expect(min(cos) >= 0.999, "kernel path gradients disagree with the plain path")
    tmp.cleanup()
    check(not failed, "training phase: " + "; ".join(failed))
    return launches


def check_rmsnorm(torch, F, ref, rmsnorm, randn, card):
    """Row 6 against ``rmsnorm_ref`` at Qwen2-7B's decode and prefill
    shapes; times both.  Returns its kernel record, timed at the decode
    shape the main path runs most (launches filled in later)."""
    d = 3584
    rec = None
    for rows in (32, 2048):
        for dt in (torch.bfloat16, torch.float32):
            x = randn(rows, d, dtype=dt, scale=3.0, shift=0.5)
            w = randn(d, dtype=dt)
            y = rmsnorm(x, w)
            torch.cuda.synchronize()
            r = ref.rmsnorm_ref(x, w)
            err = (y.float() - r.float()).abs()
            # bf16: at most one bf16 step apart (2^-7 of |y|), from the output
            # rounding; fp32: the same moments summed in another order
            rtol = 2**-7 if dt == torch.bfloat16 else 1e-5
            ok = bool((err <= 1e-5 + rtol * r.float().abs()).all())
            print(f"rmsnorm ({rows}, {d}) {str(dt)[6:]}: max err {err.max().item():.3g} "
                  f"(tol 1e-5 + {rtol:.3g}*|y|)")
            check(ok, f"rmsnorm ({rows}, {d}) {dt}")
        x = randn(rows, d, scale=3.0, shift=0.5)
        w = randn(d)
        ms = time_ms(torch, lambda: rmsnorm(x, w))
        dev_ms = device_ms(torch, lambda: rmsnorm(x, w), "rmsnorm")
        plain_ms = time_ms(torch, lambda: ref.rmsnorm_ref(x, w))
        lib_ms = time_ms(torch, lambda: F.rms_norm(x, (d,), w, 1e-5))
        nbytes = 2 * rows * d * 2 + d * 2
        bound_ms, bound_by = bound(4 * rows * d, nbytes, PEAK_FP32_FLOPS)
        print(f"rmsnorm ({rows}, {d}) bf16 on {card}: {ms:.4f} ms back to back, device {fmt_ms(dev_ms)} "
              f"ms (bound {bound_ms:.5f} ms by {bound_by}, "
              f"{per_device_ms(nbytes, dev_ms, 'GB/s', 1e6)}), plain {plain_ms:.4f} ms, "
              f"F.rms_norm {lib_ms:.4f} ms")
        if rec is None:
            err = (rmsnorm(x, w).float() - ref.rmsnorm_ref(x, w).float()).abs().max().item()
            rec = {"name": "rmsnorm", "route": "triton", "source": "src/repro_torch/kernels/rmsnorm.py",
                   "replaces": "src/repro/kernels/rmsnorm.py:54", "launches": 0,
                   "max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": lib_ms}
    return rec


def check_flash_decode(torch, F, ref, flash_decode, randn, card):
    """Row 8 against ``decode_attention_ref`` at Qwen2-7B's decode shape
    with ragged lengths (0, 1 and T among them), at group 1 and at D 64, in
    bf16 (the only dtype the kernel takes); times the main shape.  Returns
    its kernel record."""
    import numpy as np

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    # the plain version rounds the normalized P to the input dtype before
    # PV (2^-9 relative in bf16) where the kernel keeps fp32
    tol = 2e-2
    cases = [
        ("qwen2-7b decode shape", dict(B=32, T=2048, H=28, Hkv=4, D=128)),
        ("group 1", dict(B=8, T=700, H=8, Hkv=8, D=128)),
        ("D=64, group 4", dict(B=8, T=333, H=16, Hkv=4, D=64)),
    ]
    main = None
    for label, c in cases:
        B, T, H, Hkv, D = c["B"], c["T"], c["H"], c["Hkv"], c["D"]
        lens = rng.integers(0, T + 1, size=B)
        lens[:3] = [0, 1, T]
        lengths = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        q = randn(B, 1, H, D)
        k = randn(B, T, Hkv, D)
        v = randn(B, T, Hkv, D)
        out = flash_decode(q, k, v, lengths)
        torch.cuda.synchronize()
        want = ref.decode_attention_ref(q, k, v, lengths)
        err = row_rel_err(out, want)
        zero = bool((out[0] == 0).all())
        print(f"flash_decode {label} (B={B}, T={T}, H={H}, Hkv={Hkv}, D={D}) bf16: rel err "
              f"{err:.3g} (tol {tol} of each row's max|ref|), length-0 row exactly 0: {zero}")
        check(err <= tol and zero and bool(out.isfinite().all()), f"flash_decode {label}")
        if main is None:
            main = (q, k, v, lengths, lens, (out.float() - want.float()).abs().max().item())
    q, k, v, lengths, lens, err0 = main
    B, T, Hkv, D = k.shape
    H = q.shape[2]
    ms = time_ms(torch, lambda: flash_decode(q, k, v, lengths))
    dev_ms = device_ms(torch, lambda: flash_decode(q, k, v, lengths), "flash_decode")
    plain_ms = time_ms(torch, lambda: ref.decode_attention_ref(q, k, v, lengths), trials=5, per_trial=5)
    qt = q.transpose(1, 2)                                   # (B, H, 1, D)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)            # (B, Hkv, T, D)
    mask = (torch.arange(T, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                                   enable_gqa=True))
    live = int(lens.sum())
    # this run's data: q and out once, each live cache row of K and V once,
    # the lengths; QK and PV of every query head over its live rows
    nbytes = 2 * B * H * D * 2 + 2 * live * Hkv * D * 2 + B * 4
    bound_ms, bound_by = bound(4 * H * D * live, nbytes)
    print(f"flash_decode B={B} T={T} H={H} Hkv={Hkv} D={D} bf16, {live} live rows of {B * T}, on "
          f"{card}: {ms:.4f} ms back to back, device {fmt_ms(dev_ms)} ms (bound {bound_ms:.4f} ms by "
          f"{bound_by}, {per_device_ms(nbytes, dev_ms, 'GB/s', 1e6)}), "
          f"plain {plain_ms:.4f} ms, scaled_dot_product_attention (length mask, GQA) {lib_ms:.4f} ms")
    return {"name": "flash_decode", "route": "cuda", "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/flash_decode.py:116", "launches": 0, "max_abs_err": err0,
            "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms}


def check_sampling(torch, ref, fused_sample, randn, card):
    """Row 7 against ``sample_ref`` at Qwen2-7B's decode shape (32, 152064)
    with -1e30 columns: identical tokens, logp within 1e-4.  Times the mix,
    all-greedy and all-sampled rows.  Returns its kernel record."""
    B, V = 32, 152064
    dev = torch.device("cuda")
    x = randn(B, V, scale=2.0)
    x[:, torch.arange(0, V, 97, device=dev)] = -1e30
    x[5, : V // 2] = -1e30
    # per row, in turn: greedy, top-k only, top-p only, both, temperature 0
    # with filters set, plain temperature; seeds past 2^31
    mix = [(0.0, 0, 1.0), (0.8, 50, 1.0), (1.0, 0, 0.95), (0.8, 50, 0.95), (0.0, 50, 0.9),
           (1.3, 0, 1.0)]
    rows = [mix[i % len(mix)] for i in range(B)]
    temp = torch.tensor([r[0] for r in rows], device=dev)
    top_k = torch.tensor([r[1] for r in rows], dtype=torch.int32, device=dev)
    top_p = torch.tensor([r[2] for r in rows], device=dev)
    seed = torch.tensor([(2**31 + 977 * i) % 2**32 for i in range(B)], device=dev)
    step = torch.tensor([3 * i for i in range(B)], device=dev)
    tok, logp = fused_sample(x, temp, top_k, top_p, seed, step)
    torch.cuda.synchronize()
    r_tok, r_logp = ref.sample_ref(x, temp, top_k, top_p, seed, step)
    same = int((tok == r_tok).sum())
    err = (logp - r_logp).abs().max().item()
    masked = bool((x.gather(1, tok.long()[:, None]) > -1e29).all())
    greedy = temp <= 0
    argmax_ok = bool((tok[greedy] == x[greedy].float().argmax(dim=-1).to(torch.int32)).all())
    print(f"fused_sample ({B}, {V}) bf16 mix: {same}/{B} tokens equal to the plain version's, "
          f"logp err {err:.3g} (tol 1e-4), no masked column drawn: {masked}, greedy rows = "
          f"first-index argmax: {argmax_ok}")
    check(same == B and err <= 1e-4 and masked and argmax_ok, "fused_sample")
    ms = time_ms(torch, lambda: fused_sample(x, temp, top_k, top_p, seed, step))
    dev_ms = device_ms(torch, lambda: fused_sample(x, temp, top_k, top_p, seed, step), "fused_sample")
    plain_ms = time_ms(torch, lambda: ref.sample_ref(x, temp, top_k, top_p, seed, step),
                       trials=5, per_trial=2)
    zeros = torch.zeros_like(temp)
    greedy_ms = time_ms(torch, lambda: fused_sample(x, zeros, top_k, top_p, seed, step))
    hot = torch.full_like(temp, 0.8)
    sampled_ms = time_ms(torch, lambda: fused_sample(x, hot, top_k, top_p, seed, step), trials=5)
    # the function reads the logits once and writes two scalars a row
    bound_ms, bound_by = bound(0, B * V * 2 + B * 20 + B * 8)
    print(f"fused_sample ({B}, {V}) bf16 on {card}: mix {ms:.4f} ms (device {fmt_ms(dev_ms)} ms; bound "
          f"{bound_ms:.5f} ms by "
          f"{bound_by}), all greedy {greedy_ms:.4f} ms, all sampled {sampled_ms:.4f} ms; plain "
          f"{plain_ms:.4f} ms; no single PyTorch call samples with this hash (library: none)")
    return {"name": "fused_sample", "route": "cuda", "source": "src/repro_torch/kernels/csrc/sampling.cu",
            "replaces": "src/repro/kernels/sampling.py:217", "launches": 0, "max_abs_err": err,
            "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def _paged_layout(torch, np, rng, lens, page, n_tables, num_pages, dev):
    """A block table for ragged ``lens`` over a pool of ``num_pages``: each
    row's pages drawn without replacement in shuffled order (page 0, the
    null page, never), the null page past each row's length."""
    table = np.zeros((len(lens), n_tables), np.int32)
    free = list(rng.permutation(np.arange(1, num_pages)))
    for b, L in enumerate(lens):
        n = -(-int(L) // page)
        table[b, :n] = [free.pop() for _ in range(n)]
    return torch.as_tensor(table, device=dev)


def check_paged_decode(torch, F, ref, paged_decode, randn, card):
    """Row 9 against ``paged_decode_attention_ref`` at Qwen2-7B's decode
    shape over the default pool (4 097 pages of 16, 128 a row): ragged
    lengths that are not page multiples, a length-0 row, null-page entries
    past each length, shuffled page order; and at group 1 and at D 64.
    Times the main shape.  Returns its kernel record."""
    import numpy as np

    dev = torch.device("cuda")
    rng = np.random.default_rng(9)
    tol = 2e-2   # the plain version rounds the normalized P to bf16 before PV
    cases = [
        ("qwen2-7b decode shape", dict(B=32, cap=2048, H=28, Hkv=4, D=128, page=16, P=4097)),
        ("group 1, page 8", dict(B=8, cap=704, H=8, Hkv=8, D=128, page=8, P=712)),
        ("D=64, group 4", dict(B=8, cap=336, H=16, Hkv=4, D=64, page=16, P=170)),
    ]
    main = None
    for label, c in cases:
        B, cap, H, Hkv, D, page, P = (c[x] for x in ("B", "cap", "H", "Hkv", "D", "page", "P"))
        if main is None:     # the lengths of flash_decode's main case (31 163 live rows)
            lens = np.random.default_rng(1).integers(0, cap + 1, size=B)
        else:
            lens = rng.integers(1, cap + 1, size=B)
            lens[3] = page * 5 + 3                      # not a page multiple
        lens[:3] = [0, 1, cap]
        check(bool((lens % page).any()), "paged_decode: every length a page multiple")
        bt = _paged_layout(torch, np, rng, lens, page, cap // page, P, dev)
        lengths = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        q = randn(B, 1, H, D)
        k_pool, v_pool = randn(P, page, Hkv, D), randn(P, page, Hkv, D)
        out = paged_decode(q, k_pool, v_pool, bt, lengths)
        torch.cuda.synchronize()
        want = ref.paged_decode_attention_ref(q, k_pool, v_pool, bt, lengths)
        err = row_rel_err(out, want)
        zero = bool((out[0] == 0).all())
        print(f"paged_decode {label} (B={B}, capacity {cap}, H={H}, Hkv={Hkv}, D={D}, page {page}, "
              f"{P} pages) bf16: rel err {err:.3g} (tol {tol} of each row's max|ref|), length-0 row "
              f"exactly 0: {zero}")
        check(err <= tol and zero and bool(out.isfinite().all()), f"paged_decode {label}")
        if main is None:
            main = (q, k_pool, v_pool, bt, lengths, lens,
                    (out.float() - want.float()).abs().max().item())
    q, k_pool, v_pool, bt, lengths, lens, err0 = main
    B, _, H, D = q.shape
    page, Hkv = k_pool.shape[1], k_pool.shape[2]
    T = bt.shape[1] * page
    ms = time_ms(torch, lambda: paged_decode(q, k_pool, v_pool, bt, lengths))
    dev_ms = device_ms(torch, lambda: paged_decode(q, k_pool, v_pool, bt, lengths), "paged_decode")
    plain_ms = time_ms(torch, lambda: ref.paged_decode_attention_ref(q, k_pool, v_pool, bt, lengths),
                       trials=5, per_trial=5)
    # the yardstick: no single PyTorch call reads through a block table, so
    # SDPA over the cache gathered beforehand (the gather is not timed)
    kt = ref._gather_pages(k_pool, bt).transpose(1, 2)
    vt = ref._gather_pages(v_pool, bt).transpose(1, 2)
    mask = (torch.arange(T, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    qt = q.transpose(1, 2)
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                                   enable_gqa=True))
    live = int(lens.sum())
    # this run's data: q and out once, each live K and V row once, the
    # lengths and the table rows; QK and PV of every query head over its
    # live rows
    nbytes = 2 * B * H * D * 2 + 2 * live * Hkv * D * 2 + B * 4 + bt.numel() * 4
    bound_ms, bound_by = bound(4 * H * D * live, nbytes)
    print(f"paged_decode B={B} capacity {T} H={H} Hkv={Hkv} D={D} page {page} bf16, {live} live rows "
          f"of {B * T}, on {card}: {ms:.4f} ms back to back, device {fmt_ms(dev_ms)} ms (bound "
          f"{bound_ms:.4f} ms by {bound_by}, {per_device_ms(nbytes, dev_ms, 'GB/s', 1e6)}), "
          f"plain {plain_ms:.4f} ms, scaled_dot_product_attention over the pre-gathered dense "
          f"cache (length mask, GQA) {lib_ms:.4f} ms")
    return {"name": "paged_decode", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:135", "launches": 0,
            "max_abs_err": err0, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}


def check_paged_prefill(torch, F, ref, paged_prefill, randn, card):
    """Row 10 against ``paged_prefill_attention_ref`` at Qwen2-7B's chunk
    shape (a 512-token chunk, H 28, Hkv 4, D 128, pages of 16): at start 0,
    at start 512 over pages shared with another row (a cached preamble),
    with fewer valid rows than the bucket, and at a 64-token bucket; and at
    page 8, group 1.  Times the start-512 chunk.  Returns its kernel
    record."""
    import numpy as np

    dev = torch.device("cuda")
    rng = np.random.default_rng(10)
    tol = 2e-2   # as the attention forward: P rounded to bf16 before PV
    H, Hkv, D, page, P, n_tables = 28, 4, 128, 16, 4097, 128
    pools = (randn(P, page, Hkv, D), randn(P, page, Hkv, D))
    # two rows that share their first 32 pages (a 512-token preamble)
    base = _paged_layout(torch, np, rng, [2048, 2048], page, n_tables, P, dev)
    base[1, :32] = base[0, :32]
    cases = [  # label, S, starts, valid rows, table
        ("512-token chunk at start 0", 512, [0, 0], [512, 512], base),
        ("512-token chunk at start 512 over shared pages", 512, [512, 512], [512, 300], base),
        ("64-token bucket, 37 valid, start 1000", 64, [1000, 530], [37, 64], base),
    ]
    main = None
    for label, S, starts, valid, bt in cases:
        B = len(starts)
        q = randn(B, S, H, D)
        st = torch.tensor(starts, dtype=torch.int32, device=dev)
        ln = torch.tensor([s + v for s, v in zip(starts, valid)], dtype=torch.int32, device=dev)
        out = paged_prefill(q, *pools, bt, st, ln)
        torch.cuda.synchronize()
        want = ref.paged_prefill_attention_ref(q, *pools, bt, st, ln)
        err = row_rel_err(out, want, dims=2)
        print(f"paged_prefill {label} (B={B}, S={S}, valid {valid}, H={H}, Hkv={Hkv}, D={D}, page "
              f"{page}) bf16: rel err {err:.3g} (tol {tol} of each query row's max|ref|)")
        check(err <= tol and bool(out.isfinite().all()), f"paged_prefill {label}")
        if "start 512" in label:
            main = (q[:1], bt[:1], st[:1], ln[:1], (out.float() - want.float()).abs().max().item())
    # page 8, group 1, D 64, a fully masked row (length 0)
    k8, v8 = randn(300, 8, 4, 64), randn(300, 8, 4, 64)
    bt8 = _paged_layout(torch, np, rng, [200, 0], 8, 30, 300, dev)
    q8 = randn(2, 40, 4, 64)
    st8 = torch.tensor([150, 0], dtype=torch.int32, device=dev)
    ln8 = torch.tensor([190, 0], dtype=torch.int32, device=dev)
    out8 = paged_prefill(q8, k8, v8, bt8, st8, ln8)
    torch.cuda.synchronize()
    err8 = row_rel_err(out8, ref.paged_prefill_attention_ref(q8, k8, v8, bt8, st8, ln8), dims=2)
    zero = bool((out8[1] == 0).all())
    print(f"paged_prefill page 8, group 1, D=64: rel err {err8:.3g} (tol {tol} of each query "
          f"row's max|ref|), fully masked row exactly 0: {zero}")
    check(err8 <= tol and zero, "paged_prefill page 8")

    q, bt, st, ln, err0 = main
    S = q.shape[1]
    start, L = int(st[0]), int(ln[0])
    fn = lambda: paged_prefill(q, *pools, bt, st, ln)     # noqa: E731
    ms = time_ms(torch, fn)
    dev_ms = device_ms(torch, fn, "paged_prefill")
    plain_ms = time_ms(torch, lambda: ref.paged_prefill_attention_ref(q, *pools, bt, st, ln),
                       trials=5, per_trial=2)
    T = bt.shape[1] * page
    kt = ref._gather_pages(pools[0], bt).transpose(1, 2)
    vt = ref._gather_pages(pools[1], bt).transpose(1, 2)
    kpos = torch.arange(T, device=dev)
    qpos = start + torch.arange(S, device=dev)
    mask = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] < L)
    qt = q.transpose(1, 2)
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                                   enable_gqa=True))
    # QK and PV over each query row's visible keys; q and out once, the live
    # K and V rows once, the table row
    visible = sum(min(start + i + 1, L) for i in range(S))
    nbytes = 2 * S * H * D * 2 + 2 * L * Hkv * D * 2 + bt.numel() * 4 + 8
    bound_ms, bound_by = bound(4 * H * D * visible, nbytes)
    print(f"paged_prefill S={S} at start {start} (context {L}) H={H} Hkv={Hkv} D={D} page {page} "
          f"bf16 on {card}: {ms:.4f} ms back to back, device {fmt_ms(dev_ms)} ms (bound {bound_ms:.4f} "
          f"ms by {bound_by}, {per_device_ms(4 * H * D * visible, dev_ms, 'TFLOP/s', 1e9)}), "
          f"plain {plain_ms:.4f} ms, scaled_dot_product_attention over the pre-gathered dense cache "
          f"(causal offset mask, GQA) {lib_ms:.4f} ms")
    return {"name": "paged_prefill", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:258", "launches": 0,
            "max_abs_err": err0, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}


def check_paged_kv_write(torch, ref, paged_kv_write, randn, card):
    """Row 11 against ``paged_kv_write_ref`` at the decode shape (B 32, the
    default pool of 4 097 pages of 16, Hkv 4, D 128): live slots on distinct
    pages, idle slots colliding on row 0 of the null page.  The written rows
    must be equal bit for bit; the null page's row 0 holds idle slots' data.
    Returns its kernel record."""
    import numpy as np

    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    B, P, page, Hkv, D = 32, 4097, 16, 4, 128
    k_pool, v_pool = randn(P, page, Hkv, D), randn(P, page, Hkv, D)
    k_new, v_new = randn(B, 1, Hkv, D), randn(B, 1, Hkv, D)
    pages = rng.choice(np.arange(1, P), size=B, replace=False)
    rows = rng.integers(0, page, size=B)
    idle = np.arange(B) % 5 == 3
    pages[idle], rows[idle] = 0, 0
    pi = torch.as_tensor(pages, dtype=torch.int32, device=dev)
    ri = torch.as_tensor(rows, dtype=torch.int32, device=dev)
    gk, gv = k_pool.clone(), v_pool.clone()
    paged_kv_write(gk, gv, k_new, v_new, pi, ri)
    torch.cuda.synchronize()
    wk, wv = k_pool.clone(), v_pool.clone()
    ref.paged_kv_write_ref(wk, wv, k_new, v_new, pi, ri)
    same = bool(torch.equal(gk[1:], wk[1:]) and torch.equal(gv[1:], wv[1:]))
    # the idle slots race on the null page's row 0, 16 bytes a store: each
    # 16-byte piece of it holds that piece of one of their rows
    cand = torch.as_tensor(np.flatnonzero(idle), device=dev)

    def pieces_from_idle(pool, new):
        got = pool[0, 0].reshape(-1, 8)                            # (Hkv * D / 8, 8)
        want = new[cand, 0].reshape(len(cand), -1, 8)
        return bool((got[None] == want).all(-1).any(0).all())

    null_ok = (pieces_from_idle(gk, k_new) and pieces_from_idle(gv, v_new)
               and torch.equal(gk[0, 1:], k_pool[0, 1:]) and torch.equal(gv[0, 1:], v_pool[0, 1:]))
    print(f"paged_kv_write B={B} ({int(idle.sum())} idle slots on the null page) bf16: live rows "
          f"equal to the plain version's {same}, each 16-byte piece of the null page's row 0 from "
          f"an idle slot's row {null_ok}")
    check(same and null_ok, "paged_kv_write")
    fn = lambda: paged_kv_write(gk, gv, k_new, v_new, pi, ri)     # noqa: E731
    ms = time_ms(torch, fn)
    dev_ms = device_ms(torch, fn, "paged_kv_write")
    plain_ms = time_ms(torch, lambda: ref.paged_kv_write_ref(wk, wv, k_new, v_new, pi, ri))
    idx = (pi.long(), ri.long())
    kn, vn = k_new[:, 0], v_new[:, 0]

    def index_put_pair():
        wk.index_put_(idx, kn)
        wv.index_put_(idx, vn)

    lib_ms = time_ms(torch, index_put_pair)
    nbytes = 2 * (2 * B * Hkv * D * 2) + 2 * B * 4       # new rows read, pool rows written
    bound_ms, bound_by = bound(0, nbytes)
    print(f"paged_kv_write B={B} Hkv={Hkv} D={D} bf16 on {card}: {ms:.4f} ms back to back, device "
          f"{fmt_ms(dev_ms)} ms (bound {bound_ms:.6f} ms by {bound_by}), plain {plain_ms:.4f} ms, "
          f"index_put_ pair {lib_ms:.4f} ms")
    return {"name": "paged_kv_write", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:340", "launches": 0,
            "max_abs_err": 0.0, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}


def _router_sizes(np, rng, tokens, E, empty=(), cap=None):
    """Group sizes from a seeded skewed router draw of ``tokens`` top-1
    choices over E experts: the experts in ``empty`` never drawn, and each
    count cut to ``cap`` (the capacity) when given."""
    p = np.exp(1.5 * rng.standard_normal(E))
    p[list(empty)] = 0.0
    counts = np.bincount(rng.choice(E, size=tokens, p=p / p.sum()), minlength=E)
    return np.minimum(counts, cap) if cap is not None else counts


def check_gmm(torch, ref, gmm, card):
    """Row 12 against ``grouped_matmul_ref`` at Llama-4-Scout's decode and
    prefill shapes, the w_out shape, Maverick's 128 experts, all groups
    empty, one group holding every row, and M = 50; rows past the sizes'
    sum must be exactly 0.  Times the decode w_in shape (the record) and
    prints the prefill and w_out times.  Returns its kernel record."""
    import numpy as np

    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    tol = 2e-2      # of each row's max|ref|: fp32 sums of the same bf16 products in another order
    d, f = 5120, 8192
    scout_w = {"w_in": (torch.randn(16, d, f, device=dev) * d ** -0.5).to(torch.bfloat16)}
    scout_w["w_out"] = (torch.randn(16, f, d, device=dev) * f ** -0.5).to(torch.bfloat16)
    cases = [
        ("scout decode, w_in", 32, "w_in", _router_sizes(np, rng, 32, 16, empty=(3,))),
        ("scout prefill, w_in, capacity 80", 1024, "w_in", _router_sizes(np, rng, 1024, 16, cap=80)),
        ("scout decode, w_out", 32, "w_out", _router_sizes(np, rng, 32, 16, empty=(0, 9))),
        ("all groups empty", 32, "w_in", np.zeros(16, np.int64)),
        ("one group holds every row", 32, "w_out", np.eye(16, dtype=np.int64)[7] * 32),
        ("M = 50", 50, "w_in", _router_sizes(np, rng, 46, 16)),
    ]
    inputs = {}
    for label, M, wname, sizes in cases:
        w = scout_w[wname]
        x = torch.randn(M, w.shape[1], device=dev).to(torch.bfloat16)
        gs = torch.as_tensor(sizes, dtype=torch.int32, device=dev)
        out = gmm(x, w, gs)
        torch.cuda.synchronize()
        want = ref.grouped_matmul_ref(x, w, gs)
        total = int(sizes.sum())
        err = row_rel_err(out[:total], want[:total]) if total else 0.0
        tail0 = bool((out[total:] == 0).all())
        print(f"gmm {label} (M={M}, K={w.shape[1]}, N={w.shape[2]}, E=16, {int((sizes > 0).sum())} "
              f"live groups, {total} rows in groups): rel err {err:.3g} (tol {tol} of each row's "
              f"max|ref|), the {M - total} rows past the groups exactly 0: {tail0}")
        check(err <= tol and tail0 and bool(out.isfinite().all()), f"gmm {label}")
        inputs[label] = (x, w, gs, sizes, (out.float() - want.float()).abs().max().item())
    # Maverick: 128 experts (10.7 GB of w_in), most of them empty at decode
    w128 = (torch.randn(128, d, f, device=dev) * d ** -0.5).to(torch.bfloat16)
    sizes = _router_sizes(np, rng, 32, 128)
    x = torch.randn(32, d, device=dev).to(torch.bfloat16)
    gs = torch.as_tensor(sizes, dtype=torch.int32, device=dev)
    out = gmm(x, w128, gs)
    torch.cuda.synchronize()
    err = row_rel_err(out, ref.grouped_matmul_ref(x, w128, gs))
    print(f"gmm maverick decode, w_in (M=32, K={d}, N={f}, E=128, {int((sizes > 0).sum())} live "
          f"groups): rel err {err:.3g} (tol {tol})")
    check(err <= tol and bool(out.isfinite().all()), "gmm maverick decode")
    del w128, out

    def timed(label):
        x, w, gs, sizes, _ = inputs[label]
        M, (E, K, N) = x.shape[0], w.shape
        live = int((sizes > 0).sum())
        ms = time_ms(torch, lambda: gmm(x, w, gs), trials=10)
        dev_ms = device_ms(torch, lambda: gmm(x, w, gs), "gmm_kernel", n=10)
        plain_ms = time_ms(torch, lambda: ref.grouped_matmul_ref(x, w, gs), trials=3, per_trial=2,
                           warmup=1)
        if hasattr(torch, "_grouped_mm"):
            ends = torch.cumsum(gs, 0, dtype=torch.int32)
            lib, lib_name = (lambda: torch._grouped_mm(x, w, offs=ends)), "torch._grouped_mm"
        else:   # the capacity-batched GEMM of the reference's XLA path, its scatter done ahead
            xe = torch.zeros(E, int(sizes.max()), K, dtype=x.dtype, device=dev)
            lib, lib_name = (lambda: torch.bmm(xe, w)), "torch.bmm over (E, max size, K)"
        lib_ms = time_ms(torch, lib, trials=10)
        # this run's data: each live group's weight once, x and y once
        nbytes = live * K * N * 2 + M * K * 2 + M * N * 2 + E * 4
        bound_ms, bound_by = bound(2 * int(sizes.sum()) * K * N, nbytes)
        print(f"gmm {label} (M={M}, K={K}, N={N}, {live} of {E} groups live) bf16 on {card}: "
              f"{ms:.4f} ms back to back, device {fmt_ms(dev_ms)} ms (bound {bound_ms:.4f} ms by "
              f"{bound_by}, {per_device_ms(nbytes, dev_ms, 'GB/s', 1e6)}), plain {plain_ms:.4f} ms, "
              f"{lib_name} {lib_ms:.4f} ms")
        return ms, dev_ms, plain_ms, bound_ms, bound_by, lib_ms

    ms, dev_ms, plain_ms, bound_ms, bound_by, lib_ms = timed("scout decode, w_in")
    timed("scout prefill, w_in, capacity 80")
    timed("scout decode, w_out")
    return {"name": "gmm", "route": "cuda", "source": "src/repro_torch/kernels/csrc/grouped_matmul.cu",
            "replaces": "src/repro/kernels/grouped_matmul.py:198", "launches": 0,
            "max_abs_err": inputs["scout decode, w_in"][4], "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}


def _grouped_mm_lib(torch, fn):
    """``torch._grouped_mm`` timed as a yardstick, or (None, why not)."""
    if not hasattr(torch, "_grouped_mm"):
        return None, "none: this PyTorch has no torch._grouped_mm"
    try:
        fn()
        torch.cuda.synchronize()
    except (RuntimeError, TypeError, ValueError) as e:
        return None, f"none: torch._grouped_mm refused this form ({str(e).splitlines()[0][:90]})"
    return time_ms(torch, fn, trials=10), "torch._grouped_mm"


def check_gmm_dw(torch, ref, gmm, gmm_dw, card):
    """Row 13 (``gmm_dw``) against ``grouped_matmul_dw_ref`` and row 12's
    transposed mode (the backward's dx) against ``grouped_matmul_ref`` on
    the transposed weights, in the ragged cases of the reference's MoE tests
    (even, Dirichlet-uneven, all empty, one group takes all, a dropped tail
    with large finite values in its rows of x and dy, interior empty
    groups), M = 77 (no multiple of a tile), Maverick's 128 experts at a
    small K and N, and Scout's w_in and w_out at M = 2048 (a 2 x 1024
    micro-batch, capacity 160).  dW: fp32 within 1e-3 of each group's
    max|ref| (bf16 products are exact in fp32; only the order of the sums
    differs), empty groups exactly 0, a repeat bit-identical; dx: 2e-2 of
    each row's max|ref|, rows past the groups exactly 0.  Times both at
    Scout's w_in training shape.  Returns the gmm_dw record."""
    import numpy as np

    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    dw_tol, dx_tol = 1e-3, 2e-2

    def bf16(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev) * scale).to(torch.bfloat16)

    cases = [
        ("even", 512, 256, 384, [64] * 8),
        ("Dirichlet-uneven", 512, 256, 384, rng.multinomial(512, rng.dirichlet(np.ones(8)))),
        ("all groups empty", 512, 256, 384, [0] * 8),
        ("one group takes all", 512, 256, 384, [0, 0, 0, 512, 0, 0, 0, 0]),
        ("dropped tail, large tail rows", 512, 256, 384, [40, 0, 77, 13, 0, 90, 30, 50]),
        ("interior empty groups", 512, 256, 384, [0, 128, 0, 0, 100, 0, 200, 84]),
        ("M = 77", 77, 256, 384, [9, 0, 31, 0, 5, 20, 12, 0]),
        ("maverick, 128 experts", 1024, 128, 256, _router_sizes(np, rng, 1024, 128, cap=16)),
        ("scout w_in, capacity 160", 2048, 5120, 8192, _router_sizes(np, rng, 2048, 16, cap=160)),
        ("scout w_out, capacity 160", 2048, 8192, 5120, _router_sizes(np, rng, 2048, 16, cap=160)),
    ]
    dw_err0, timing = 0.0, None
    for label, M, K, N, sizes in cases:
        sizes = np.asarray(sizes, np.int64)
        E, total = len(sizes), int(sizes.sum())
        x = bf16(M, K)
        dy = bf16(M, N)
        x[total:], dy[total:] = 1e30, -1e30          # rows past the groups: never summed
        w = bf16(E, K, N, scale=K ** -0.5)
        gs = torch.as_tensor(sizes, dtype=torch.int32, device=dev)
        dw = gmm_dw(x, dy, gs)
        again = gmm_dw(x, dy, gs)
        dw16 = gmm_dw(x, dy, gs, out_dtype=torch.bfloat16)
        dx = gmm(dy, w, gs, transpose_w=True)
        torch.cuda.synchronize()
        want = ref.grouped_matmul_dw_ref(x, dy, gs)
        live = [g for g in range(E) if sizes[g] > 0]
        err = row_rel_err(dw[live], want[live]) if live else 0.0
        err16 = row_rel_err(dw16[live].float(), want[live]) if live else 0.0
        empty0 = all(bool((dw[g] == 0).all()) and bool((dw16[g] == 0).all())
                     for g in range(E) if sizes[g] == 0)
        same = torch.equal(dw, again)
        want_dx = ref.grouped_matmul_ref(dy, w.transpose(1, 2), gs)
        err_dx = row_rel_err(dx[:total], want_dx[:total]) if total else 0.0
        tail0 = bool((dx[total:] == 0).all())
        print(f"gmm_dw {label} (M={M}, K={K}, N={N}, E={E}, {len(live)} live groups, {total} rows "
              f"in groups): rel err {err:.3g} (tol {dw_tol} of each group's max|ref|), bf16 output "
              f"{err16:.3g} (tol {dw_tol} + 2^-8), empty groups exactly 0: {empty0}, a repeat "
              f"bit-identical: {same}; dx (gmm, transposed w) rel err {err_dx:.3g} (tol {dx_tol} "
              f"of each row's max|ref|), the {M - total} rows past the groups exactly 0: {tail0}")
        check(err <= dw_tol and err16 <= dw_tol + 2 ** -8 and empty0 and same
              and bool(dw.isfinite().all()), f"gmm_dw {label}")
        check(err_dx <= dx_tol and tail0 and bool(dx.isfinite().all()), f"gmm transposed {label}")
        if label.startswith("scout w_in"):
            dw_err0 = (dw16.float() - want).abs().max().item()
            timing = (x, dy, w, gs, sizes)
        del x, dy, w, dw, again, dw16, dx, want, want_dx

    x, dy, w, gs, sizes = timing
    M, K, N, E = x.shape[0], x.shape[1], dy.shape[1], len(sizes)
    total, live = int(sizes.sum()), int((sizes > 0).sum())
    ends = torch.cumsum(gs, 0, dtype=torch.int32)
    # the main path writes dW in the weights' dtype, bf16
    ms = time_ms(torch, lambda: gmm_dw(x, dy, gs, out_dtype=torch.bfloat16), trials=10)
    dev_ms = device_ms(torch, lambda: gmm_dw(x, dy, gs, out_dtype=torch.bfloat16), "gmm_dw_kernel",
                       n=10)
    ms32 = time_ms(torch, lambda: gmm_dw(x, dy, gs), trials=10)
    plain_ms = time_ms(torch, lambda: ref.grouped_matmul_dw_ref(x, dy, gs), trials=3, per_trial=1,
                       warmup=1)
    lib_ms, lib_name = _grouped_mm_lib(torch, lambda: torch._grouped_mm(x.t(), dy, offs=ends))
    flops = 2 * total * K * N
    nbytes = total * (K + N) * 2 + E * K * N * 2 + E * 4
    bound_ms, bound_by = bound(flops, nbytes)
    bound32, by32 = bound(flops, nbytes + E * K * N * 2)
    print(f"gmm_dw scout w_in training shape (M={M}, K={K}, N={N}, {live} of {E} groups live, "
          f"{total} rows) on {card}: bf16 dW {ms:.4f} ms back to back, device {fmt_ms(dev_ms)} ms "
          f"(bound {bound_ms:.4f} ms by {bound_by}, {per_device_ms(flops, dev_ms, 'TFLOP/s', 1e9)}); "
          f"fp32 dW {ms32:.4f} ms (bound {bound32:.4f} ms by {by32}); plain {plain_ms:.4f} ms; "
          f"{lib_name}" + (f" {lib_ms:.4f} ms" if lib_ms is not None else ""))
    dx_ms = time_ms(torch, lambda: gmm(dy, w, gs, transpose_w=True), trials=10)
    dx_dev = device_ms(torch, lambda: gmm(dy, w, gs, transpose_w=True), "gmm_kernel", n=10)
    dx_plain = time_ms(torch, lambda: ref.grouped_matmul_ref(dy, w.transpose(1, 2), gs), trials=3,
                       per_trial=1, warmup=1)
    wt = w.transpose(1, 2)
    dx_lib, dx_lib_name = _grouped_mm_lib(torch, lambda: torch._grouped_mm(dy, wt, offs=ends))
    dx_bytes = live * K * N * 2 + M * N * 2 + M * K * 2 + E * 4
    dx_bound, dx_by = bound(2 * total * K * N, dx_bytes)
    print(f"gmm transposed (dx = dy @ w[g]^T) scout w_in training shape (M={M}, depth {N}, out "
          f"{K}) on {card}: {dx_ms:.4f} ms back to back, device {fmt_ms(dx_dev)} ms (bound "
          f"{dx_bound:.4f} ms by {dx_by}, {per_device_ms(2 * total * K * N, dx_dev, 'TFLOP/s', 1e9)}), "
          f"plain {dx_plain:.4f} ms, {dx_lib_name}" + (f" {dx_lib:.4f} ms" if dx_lib is not None else ""))
    return {"name": "gmm_dw", "route": "cuda", "source": "src/repro_torch/kernels/csrc/grouped_matmul.cu",
            "replaces": "src/repro/kernels/grouped_matmul.py:280", "launches": 0,
            "max_abs_err": dw_err0, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}


def _ssd_case(torch, g, B, S, H, P, G, N, dt_shift):
    """SSD scan inputs as an SSM layer makes them: x, B and C sliced out of
    one bf16 activation (strided views), dt = softplus(raw + shift) in
    fp32, A = -U[1, 16) (Mamba-2's init), D around 1."""
    dev = torch.device("cuda")
    conv = torch.randn(B, S, H * P + 2 * G * N, generator=g, device=dev).to(torch.bfloat16)
    x = conv[..., :H * P].unflatten(-1, (H, P))
    Bm = conv[..., H * P:H * P + G * N].unflatten(-1, (G, N))
    Cm = conv[..., H * P + G * N:].unflatten(-1, (G, N))
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g, device=dev) + dt_shift)
    A = -(1 + 15 * torch.rand(H, generator=g, device=dev))
    D = 1 + 0.1 * torch.randn(H, generator=g, device=dev)
    return x, dt, A, Bm, Cm, D


def ssd_flops(B, S, H, P, N):
    """FLOPs of the cheapest exact form of the scan, the sequential
    recurrence: per token and head the state's decay and update (3·P·N),
    its read-out y = h·C (2·P·N), dt·x and D·x (3·P).  The chunked dual
    form needs more at any chunk: at L = 64 with only the causal triangle
    of C·Bᵀ and att·x, 2·(L(L+1)/2·(N + P) + 2·L·P·N) + P·N a chunk."""
    return (5 * P * N + 3 * P) * B * S * H


def check_ssd_scan(torch, ref, ssd_scan, card):
    """Row 14 against ``ssd_scan_ref`` (the kernel's math in fp32, at the
    configs' chunk of 128) at Mamba2-2.7B's prefill shape at S = 1024 and
    at a tail length, batch 4, two groups, S shorter than a chunk, and
    large steps (dt·|A| up to ~50 a row, so exp(cum_t − cum_s) overflows
    above the diagonal and must be selected away).  y within 2 bf16 steps
    of each row's max|plain|, the state within 1e-4 of each head's
    max|plain|, no NaN.  Times the S = 1024 shape.  Returns its record."""
    g = torch.Generator(device="cuda").manual_seed(16)
    cases = [
        ("mamba2-2.7b prefill S=1024", (1, 1024, 80, 64, 1, 128), -4.0),
        ("mamba2-2.7b prefill, tail S=1000", (1, 1000, 80, 64, 1, 128), -4.0),
        ("batch 4", (4, 300, 8, 64, 1, 128), -4.0),
        ("G=2", (2, 200, 8, 64, 2, 128), -4.0),
        ("S < chunk", (1, 37, 80, 64, 1, 128), -4.0),
        ("jamba reduced shape", (1, 77, 16, 32, 1, 16), -4.0),
        ("large steps", (1, 256, 8, 64, 1, 128), 1.5),
    ]
    inputs = {}
    for label, (B, S, H, P, G, N), shift in cases:
        args = _ssd_case(torch, g, B, S, H, P, G, N, shift)
        y, state = ssd_scan(*args)
        torch.cuda.synchronize()
        want_y, want_state = ref.ssd_scan_ref(*args, chunk=128)
        top = want_y.float().abs().amax(-1, keepdim=True)
        step = torch.exp2(torch.floor(torch.log2(top.clamp_min(1e-30))) - 7)
        y_steps = ((y.float() - want_y.float()).abs() / step).max().item()
        s_err = row_rel_err(state, want_state, dims=2)
        finite = bool(y.isfinite().all() and state.isfinite().all())
        print(f"ssd_scan {label} (B={B}, S={S}, H={H}, P={P}, G={G}, N={N}): y within "
              f"{y_steps:.3g} bf16 steps of each row's max|plain| (tol 2), state rel err "
              f"{s_err:.3g} (tol 1e-4 of each head's max|plain|), finite {finite}")
        check(y_steps <= 2 and s_err <= 1e-4 and finite, f"ssd_scan {label}")
        inputs[label] = (args, (y.float() - want_y.float()).abs().max().item())
    args, max_err = inputs["mamba2-2.7b prefill S=1024"]
    x, dt, A, Bm, Cm, D = args
    B, S, H, P = x.shape
    N = Bm.shape[3]
    ms = time_ms(torch, lambda: ssd_scan(*args), trials=10)
    dev_ms = device_ms(torch, lambda: ssd_scan(*args), "ssd_scan_kernel", n=10)
    plain_ms = time_ms(torch, lambda: ref.ssd_scan_ref(*args, chunk=128), trials=3, per_trial=2,
                       warmup=1)
    flops = ssd_flops(B, S, H, P, N)
    nbytes = 2 * B * S * H * P * 2 + B * H * P * N * 4 + B * S * H * 4 + 2 * B * S * N * 2
    bound_ms, bound_by = bound(flops, nbytes, PEAK_FP32_FLOPS)
    print(f"ssd_scan mamba2-2.7b prefill (B={B}, S={S}, H={H}, P={P}, N={N}) bf16 on {card}: "
          f"{ms:.4f} ms back to back, device {fmt_ms(dev_ms)} ms (bound {bound_ms:.4f} ms by "
          f"{bound_by}: {flops / 1e9:.2f} GFLOP of the recurrence at fp32 peak, "
          f"{nbytes / 1e6:.1f} MB; {per_device_ms(flops, dev_ms, 'TFLOP/s', 1e9)}), plain "
          f"{plain_ms:.4f} ms, library: none (no single PyTorch call computes the scan)")
    return {"name": "ssd_scan", "route": "cuda", "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:136", "launches": 0, "max_abs_err": max_err,
            "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def generate_phase(torch, counters, card):
    """Slice 4a: Qwen2-7B generation at full width and depth through
    ``LLM.generate`` over the dense KV cache.  Returns the launch counts of
    the first generate call (the main path's run), the model, and the load
    (prompts, their lengths, their sampling params) for the paged phase."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, build_model
    from repro_torch.serving.api import LLM
    from repro_torch.serving.engine import Request
    from repro_torch.serving.sampling import SamplingParams

    failed = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    cfg = dataclasses.replace(get_config("qwen2-7b"), param_dtype="bfloat16")
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    print(f"built {cfg.name} ({cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads}/"
          f"{cfg.num_kv_heads} heads, {cfg.param_count() / 1e9:.2f}B params, bf16) on cuda in "
          f"{t_build:.1f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    slots, max_len, n, max_new = 32, 2048, 64, 256
    rng = np.random.default_rng(0)
    lengths = rng.integers(64, 1025, size=n)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(L)).tolist() for L in lengths]
    params = [SamplingParams(max_new=max_new) if i % 2 == 0 else
              SamplingParams(temperature=0.8, top_k=50, top_p=0.95, seed=i, max_new=max_new,
                             logprobs=True) for i in range(n)]
    llm = LLM(model, slots=slots, max_len=max_len)
    eng = llm.engine
    L = cfg.num_layers
    names = ("flash_attention_fwd", "rmsnorm", "flash_decode", "fused_sample")

    def zero():
        for name in names:
            counters[name].launches = 0

    def read():
        return {name: counters[name].launches for name in names}

    # the main path: every count set to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    zero()
    dec0 = eng.decode_steps
    t0 = time.perf_counter()
    first = llm.generate(prompts, params)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = read()
    n_dec = eng.decode_steps - dec0
    want = {"flash_attention_fwd": L * n, "rmsnorm": (2 * L + 1) * (n + n_dec),
            "flash_decode": L * n_dec, "fused_sample": n + n_dec}
    print(f"main path: LLM.generate of {n} prompts ({int(lengths.sum())} prompt tokens, "
          f"max_new {max_new}) on {slots} slots: {n} admissions, {n_dec} decode steps, "
          f"{t_first:.2f} s (first call, set-up included); launches {launches} (want {want})")
    expect(launches == want, "generation launch counts")
    gen = [len(c.tokens) for c in first]
    expect(all(c.finish_reason == "length" for c in first) and gen == [max_new] * n,
           "finish reasons / lengths")
    expect(all(np.isfinite(c.logprobs).all() for c in first if c.logprobs), "non-finite logprobs")

    t0 = time.perf_counter()
    second = llm.generate(prompts, params)
    torch.cuda.synchronize()
    t_steady = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    same = all(a.tokens == b.tokens and a.finish_reason == b.finish_reason
               for a, b in zip(first, second))
    print(f"second generate call: tokens and finish reasons identical: {same}")
    expect(same, "a repeated generate differs")
    ttft = sorted(c.ttft_s for c in second)
    toks = sum(len(c.tokens) for c in second)
    print(f"Qwen2-7B LLM.generate on {card}: {toks / t_steady:.1f} generated tokens/s ({toks} tokens "
          f"in {t_steady:.3f} s, steady call), TTFT p50 {1e3 * ttft[n // 2]:.1f} ms, p95 "
          f"{1e3 * ttft[int(0.95 * (n - 1))]:.1f} ms, peak memory {peak_gb:.2f} GB; build "
          f"{t_build:.1f} s, first call {t_first:.2f} s")

    # a seeded request alone: the same tokens as in the mix
    alone = llm.generate([prompts[1]], [params[1]])[0]
    print(f"seeded request 1 alone vs in the mix: identical {alone.tokens == first[1].tokens}")
    expect(alone.tokens == first[1].tokens, "a seeded request depends on its batch mates")

    # the steady decode loop: per-step launches, no host sync but the one
    # transfer, the step time, and a profile
    for i in range(slots):
        eng.submit(Request(uid=10_000 + i, prompt=np.asarray(prompts[i], np.int32),
                           params=dataclasses.replace(params[i], max_new=64)))
    eng.step()                       # admits every slot, then decodes
    zero()
    eng.step()
    per_step = read()
    print(f"one steady decode step: launches {per_step} (want flash_decode {L}, rmsnorm "
          f"{2 * L + 1}, fused_sample 1, flash_attention_fwd 0)")
    expect(per_step == {"flash_attention_fwd": 0, "rmsnorm": 2 * L + 1, "flash_decode": L,
                        "fused_sample": 1}, "launches per decode step")
    for _ in range(8):
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng.step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    print("8 steady decode steps under torch.cuda.set_sync_debug_mode('error'): no host sync "
          "outside the one transfer")
    t0 = time.perf_counter()
    for _ in range(16):
        eng.step()              # each step ends in its one device-to-host copy
    step_ms = (time.perf_counter() - t0) / 16 * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(8):
            eng.step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, groups, kern = kernel_groups(prof, DeviceType)
    print(f"decode step of {slots} slots on {card}: {step_ms:.2f} ms ({slots / step_ms * 1e3:.0f} "
          f"tokens/s at full slots)")
    if busy_ms == 0:
        print("profile: the profiler saw no device time")
    else:
        print(f"profile of 8 decode steps on {card}: wall {wall_ms:.1f} ms (under the profiler), "
              f"device busy {busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
        print("profile by group: " + ", ".join(
            f"{k} {v:.2f} ms ({v / busy_ms:.1%})" for k, v in groups.items() if v))
        for name, t, cnt in sorted(kern, key=lambda r: -r[1])[:12]:
            print(f"  {t:9.2f} ms {cnt:6d}x  {name[:110]}")
        host = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CPU),
                      key=lambda e: -e.self_cpu_time_total)[:10]
        print("host time by op (self CPU ms, calls): " + ", ".join(
            f"{e.key} {e.self_cpu_time_total / 1e3:.1f} ({e.count})" for e in host))
    eng.run()
    del prof

    # kernel path against plain path (kernel_impl="torch", the same
    # weights), through the engine's own route: bucketed batch-1 prefills
    # written into 32 slots, then lockstep decode steps with per-slot
    # positions and idle slots reset, each slot fed the tokens the main run
    # drew for its prompt (teacher forcing)
    del llm, eng
    picks = [int(i) for i in np.argsort(lengths)[:: n // 8]]   # 8 prompts, short to long
    n_forced = 32
    forced = torch.zeros((n_forced, slots), dtype=torch.int32, device=model.device)
    for slot, i in enumerate(picks):
        forced[:, slot] = torch.tensor(first[i].tokens[:n_forced], dtype=torch.int32)
    plain = Model(dataclasses.replace(cfg, kernel_impl="torch"), model.params.tree())
    route = dict(slots=slots, max_len=max_len)
    route_prompts = [prompts[i] for i in picks]
    k_lg, _ = engine_logits(torch, np, model, route, route_prompts, forced)
    p_lg, _ = engine_logits(torch, np, plain, route, route_prompts, forced)
    compare_logits(torch, k_lg, p_lg,
                   f"kernel path vs plain path through the engine (8 slots of 32, prompts of "
                   f"{sorted(int(lengths[i]) for i in picks)} tokens, bucketed prefill + "
                   f"{n_forced} teacher-forced decode steps with per-slot positions)", expect)
    del plain
    check(not failed, "generation phase: " + "; ".join(failed))
    return launches, model, (prompts, lengths, params)


def engine_logits(torch, np, m, engine_kw, prompts, forced, warm=0):
    """Logits of ``m`` through the engine's own route: the prompts admitted
    to slots 0.. in order (the first ``warm`` of them prefilled to the end
    before the others are admitted, so that the later ones can hit their
    registered blocks), every prefill run to its end, then one decode step
    per row of ``forced`` (teacher forcing: ``forced[t]`` is each slot's
    input token).  Returns (1 + steps, len(prompts), V) fp32: the logits
    each slot's first token was drawn from, then each decode step's."""
    from repro_torch.serving.api import LLM
    from repro_torch.serving.engine import Request
    from repro_torch.serving.sampling import SamplingParams

    n = len(prompts)
    first, seen = {}, []
    decode_step = m.decode_step

    def decode_spy(*a, **kw):
        lg, c = decode_step(*a, **kw)
        seen.append(lg[:n, -1].float())
        return lg, c

    m.decode_step = decode_spy
    try:
        e = LLM(m, **engine_kw).engine
        emit_first = e._emit_first

        def first_spy(slot, logits):
            first[slot] = logits[:, -1].float()
            emit_first(slot, logits)

        e._emit_first = first_spy

        def admit(idx):
            for i in idx:
                e.submit(Request(uid=50_000 + i, prompt=np.asarray(prompts[i], np.int32),
                                 params=SamplingParams(max_new=forced.shape[0] + 8)))
            e._admit()
            while e._prefilling:
                e._advance_prefill(e._prefilling[0])

        admit(range(warm))
        admit(range(warm, n))
        for t in range(forced.shape[0]):
            e._last_tok = forced[t].clone()
            e.step()
        stats = dict(e.alloc.stats) if e.alloc is not None else {}
        del e
    finally:
        del m.decode_step
    lg = torch.cat([torch.cat([first[i] for i in range(n)])[None], torch.stack(seen)])
    return lg[..., : m.cfg.vocab_size], stats      # the -1e30 vocab padding left out


def first_token_logits(torch, np, eng, prompts):
    """The logits each prompt's first token is drawn from, through the
    engine's own admission over whatever its prefix cache holds: every
    prompt submitted for one greedy token and run to its end.  Returns
    ((len(prompts), V) fp32, the prefix-cache stats of this run)."""
    from repro_torch.serving.engine import Request
    from repro_torch.serving.sampling import SamplingParams

    got, emit_first = {}, eng._emit_first
    before = dict(eng.alloc.stats)

    def first_spy(slot, logits):
        got[eng.slot_req[slot].uid] = logits[0, -1].float()
        emit_first(slot, logits)

    eng._emit_first = first_spy
    try:
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=60_000 + i, prompt=np.asarray(p, np.int32),
                               params=SamplingParams(max_new=1)))
        eng.run()
    finally:
        del eng._emit_first
    stats = {k: v - before[k] for k, v in eng.alloc.stats.items()}
    lg = torch.stack([got[60_000 + i] for i in range(len(prompts))])
    return lg[:, : eng.model.cfg.vocab_size], stats


def compare_logits(torch, got, want, label, expect):
    """Cosine >= 0.999 at every slot-step, and the same top-1 wherever the
    reference side's top-2 gap exceeds that slot-step's max |dlogit|."""
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    dmax = (got - want).abs().amax(dim=-1)
    top2 = want.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > dmax
    agree = got.argmax(-1) == want.argmax(-1)
    print(f"{label}: logits cosine min {cos.min().item():.6f} (floor 0.999), max |dlogit| "
          f"{dmax.max().item():.4f}; top-1 agrees on {int((agree & decided).sum())} of "
          f"{int(decided.sum())} decided slot-steps; {int((~decided).sum())} closer than that "
          f"({int((agree & ~decided).sum())} agree)")
    expect(bool((cos >= 0.999).all()), f"{label}: cosine below 0.999")
    expect(bool(agree[decided].all()), f"{label}: top-1 differs where decided")


def paged_phase(torch, counters, card, model, load):
    """Slice 4b: Qwen2-7B generation at full width and depth through
    ``LLM.generate`` over the paged KV cache with prefix caching and
    512-token chunked prefill, on the dense phase's model and load, half of
    the prompts behind one shared 512-token preamble.  Returns the launch
    counts of the first generate call (the main path's run)."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.model import Model
    from repro_torch.serving.api import LLM
    from repro_torch.serving.engine import Request, to_host
    from repro_torch.serving.sampling import SamplingParams

    failed = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    cfg = model.cfg
    L = cfg.num_layers
    base_prompts, lengths, params = load
    n, slots, max_len, chunk, page = len(base_prompts), 32, 2048, 512, 16
    # one shared preamble in front of half the prompts, as the reference's
    # serve launcher builds its shared-scaffold load
    rng = np.random.default_rng(1)
    preamble = rng.integers(0, cfg.vocab_size, size=512).tolist()
    prompts = [preamble + p if i % 2 else list(p) for i, p in enumerate(base_prompts)]
    plens = [len(p) for p in prompts]
    kw = dict(slots=slots, max_len=max_len, cache_layout="paged", page_size=page,
              prefix_cache=True, prefill_chunk=chunk)
    llm = LLM(model, profile=True, **kw)
    eng = llm.engine
    names = ("flash_attention_fwd", "flash_decode", "rmsnorm", "fused_sample", "paged_decode",
             "paged_prefill", "paged_kv_write")

    def zero():
        for name in names:
            counters[name].launches = 0

    def read():
        return {name: counters[name].launches for name in names}

    # the main path: every count set to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    zero()
    dec0, ch0 = eng.decode_steps, eng.prefill_chunks
    t0 = time.perf_counter()
    first = llm.generate(prompts, params)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = read()
    n_dec, n_chunk = eng.decode_steps - dec0, eng.prefill_chunks - ch0
    want = {"flash_attention_fwd": 0, "flash_decode": 0, "rmsnorm": (2 * L + 1) * (n_dec + n_chunk),
            "fused_sample": n + n_dec, "paged_decode": L * n_dec, "paged_prefill": L * n_chunk,
            "paged_kv_write": L * n_dec}
    stats1 = dict(eng.alloc.stats)
    print(f"paged main path: LLM.generate of {n} prompts ({sum(plens)} prompt tokens, half behind "
          f"a 512-token preamble) on {slots} slots, pages of {page} ({eng.alloc.num_pages} pages, "
          f"prefix cache, {chunk}-token chunks): {n_chunk} prefill chunks, {n_dec} decode steps, "
          f"{t_first:.2f} s (first call, set-up included); prefix cache {stats1}; launches "
          f"{launches} (want {want})")
    expect(launches == want, "paged launch counts")
    expect(stats1["hit_tokens"] > 0, "no prefix-cache hit in the main run")
    gen = [len(c.tokens) for c in first]
    max_new = params[0].max_new
    expect(all(c.finish_reason == "length" for c in first) and gen == [max_new] * n,
           "paged finish reasons / lengths")
    expect(all(np.isfinite(c.logprobs).all() for c in first if c.logprobs),
           "paged non-finite logprobs")

    # the steady call: the same load from a cold prefix cache (only the
    # preamble is shared), so it repeats the main call's hits exactly
    eng.alloc.drop_cache()
    t0 = time.perf_counter()
    second = llm.generate(prompts, params)
    torch.cuda.synchronize()
    t_steady = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    same = all(a.tokens == b.tokens for a, b in zip(first, second))
    stats2 = {k: v - stats1[k] for k, v in eng.alloc.stats.items()}
    print(f"second call after alloc.drop_cache(): tokens identical to the first {same}; its "
          f"prefix cache {stats2}")
    expect(same, "a repeat after drop_cache differs")
    ttft = sorted(c.ttft_s for c in second)
    toks = sum(len(c.tokens) for c in second)
    print(f"Qwen2-7B paged LLM.generate on {card}: {toks / t_steady:.1f} generated tokens/s "
          f"({toks} tokens in {t_steady:.3f} s, steady call), TTFT p50 {1e3 * ttft[n // 2]:.1f} ms, "
          f"p95 {1e3 * ttft[int(0.95 * (n - 1))]:.1f} ms, peak memory {peak_gb:.2f} GB; first call "
          f"{t_first:.2f} s")
    # a warm call: every prompt's full blocks are cached by now
    stats_before = dict(eng.alloc.stats)
    t0 = time.perf_counter()
    third = llm.generate(prompts, params)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    # not held to the first call's tokens: a warm prompt recomputes only its
    # tail past the last full cached page (the last token alone on a
    # whole-prompt hit), and cuBLAS sums a short chunk's products in another
    # order than the 512-row chunk that first computed them; held instead at
    # the logits below, and where the tokens first part is printed
    same3 = sum(a.tokens == b.tokens for a, b in zip(first, third))
    ttft3 = sorted(c.ttft_s for c in third)
    stats3 = {k: v - stats_before[k] for k, v in eng.alloc.stats.items()}
    print(f"warm call (whole prompts cached): {same3} of {n} requests with the first call's "
          f"tokens, "
          f"{sum(len(c.tokens) for c in third) / t_warm:.1f} generated tokens/s, TTFT p50 "
          f"{1e3 * ttft3[n // 2]:.1f} ms, p95 {1e3 * ttft3[int(0.95 * (n - 1))]:.1f} ms; its prefix "
          f"cache {stats3}")
    for kind, pick in (("greedy", lambda i: params[i].temperature == 0),
                       ("sampled", lambda i: params[i].temperature > 0)):
        part = sorted(next((j for j, (x, y) in enumerate(zip(first[i].tokens, third[i].tokens))
                            if x != y), max_new) for i in range(n) if pick(i))
        print(f"warm call, {kind} requests: index of the first token that differs from the first "
              f"call's (of {max_new}; {max_new} = none): min {part[0]}, median "
              f"{part[len(part) // 2]}, max {part[-1]}")
    eng.alloc.check_invariants()
    # the warm call's witness: each prompt's first-token logits with every
    # full block cached (the tail recomputed from a page-aligned start, a
    # whole-prompt hit through copy-on-write) against a cold cache's
    warm_lg, warm_stats = first_token_logits(torch, np, eng, prompts)
    eng.alloc.drop_cache()
    cold_lg, _ = first_token_logits(torch, np, eng, prompts)
    print(f"first-token logits of the {n} prompts from a warm prefix cache (its prefix cache "
          f"{warm_stats}) and after alloc.drop_cache()")
    compare_logits(torch, warm_lg, cold_lg, "warm-cache vs cold-cache first-token logits", expect)
    del warm_lg, cold_lg
    eng.alloc.check_invariants()

    # the steady decode loop: per-step launches, no host sync but the one
    # transfer, the step time, the StepTimer spans, a profile
    for i in range(slots):
        eng.submit(Request(uid=10_000 + i, prompt=np.asarray(prompts[i], np.int32),
                           params=dataclasses.replace(params[i], max_new=max_len - plens[i])))
    eng.step()
    while eng._prefilling or eng.queue:
        eng.step()
    zero()
    eng.step()
    per_step = read()
    want_step = {"flash_attention_fwd": 0, "flash_decode": 0, "rmsnorm": 2 * L + 1,
                 "fused_sample": 1, "paged_decode": L, "paged_prefill": 0, "paged_kv_write": L}
    print(f"one steady paged decode step: launches {per_step} (want {want_step})")
    expect(per_step == want_step, "launches per paged decode step")
    table = eng.cache["block_table"]
    transfers = to_host.transfers
    for _ in range(8):
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng.step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    expect(to_host.transfers - transfers == 8, "a steady paged step made another host transfer")
    expect(eng.cache["block_table"] is table, "the block table moved in a steady step")
    print(f"8 steady paged decode steps under torch.cuda.set_sync_debug_mode('error'): no host "
          f"sync outside the one transfer a step ({to_host.transfers - transfers} transfers); the "
          f"block table did not move")
    eng.step_timer.totals.clear()
    t0 = time.perf_counter()
    for _ in range(16):
        eng.step()
    step_ms = (time.perf_counter() - t0) / 16 * 1e3
    spans = {k: round(v["mean_s"] * 1e3, 3) for k, v in eng.step_timer.summary().items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(8):
            eng.step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, groups, kern = kernel_groups(prof, DeviceType)
    print(f"paged decode step of {slots} slots on {card}: {step_ms:.2f} ms "
          f"({slots / step_ms * 1e3:.0f} tokens/s at full slots); StepTimer span means (ms) {spans}")
    if busy_ms == 0:
        print("profile: the profiler saw no device time")
    else:
        print(f"profile of 8 paged decode steps on {card}: wall {wall_ms:.1f} ms (under the "
              f"profiler), device busy {busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
        print("profile by group: " + ", ".join(
            f"{k} {v:.2f} ms ({v / busy_ms:.1%})" for k, v in groups.items() if v))
        for name, t, cnt in sorted(kern, key=lambda r: -r[1])[:12]:
            print(f"  {t:9.2f} ms {cnt:6d}x  {name[:110]}")
        host = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CPU),
                      key=lambda e: -e.self_cpu_time_total)[:10]
        print("host time by op (self CPU ms, calls): " + ", ".join(
            f"{e.key} {e.self_cpu_time_total / 1e3:.1f} ({e.count})" for e in host))
    del prof
    for r in list(eng.slot_req):
        if r is not None:
            eng.cancel(r)
    eng.alloc.check_invariants()
    expect(eng.alloc.free_pages == eng.alloc.num_pages - 1, "pages leaked after the paged run")
    del llm, eng
    gc.collect()
    torch.cuda.empty_cache()

    # the paged kernel route against the plain route (kernel_impl="torch")
    # and against the dense kernel route, through the engine: 8 prompts
    # (four behind the preamble, one the preamble alone: a whole-prompt hit,
    # copy-on-write), chunked prefill, 32 teacher-forced decode steps with
    # per-slot positions and 24 idle slots
    order = [int(i) for i in np.argsort(lengths)]
    # short to long; a preamble prompt first, so that it registers its
    # blocks before the others are admitted
    picks = [i for i in order if i % 2][::8][:4] + [i for i in order if i % 2 == 0][::11][:3]
    route_prompts = [prompts[i] for i in picks] + [list(preamble)]
    n_forced = 32
    forced = torch.zeros((n_forced, slots), dtype=torch.int32, device=model.device)
    for slot, i in enumerate(picks + [picks[-1]]):
        forced[:, slot] = torch.tensor(first[i].tokens[:n_forced], dtype=torch.int32)
    plain = Model(dataclasses.replace(cfg, kernel_impl="torch"), model.params.tree())
    k_lg, k_stats = engine_logits(torch, np, model, kw, route_prompts, forced, warm=1)
    p_lg, _ = engine_logits(torch, np, plain, kw, route_prompts, forced, warm=1)
    d_lg, _ = engine_logits(torch, np, model, dict(slots=slots, max_len=max_len), route_prompts,
                            forced)
    print(f"paged route: 8 slots of {slots}, prompts of {[len(p) for p in route_prompts]} tokens, "
          f"prefix cache {k_stats}")
    expect(k_stats.get("cow_copies", 0) >= 1 and k_stats.get("hit_tokens", 0) > 0,
           "the paged route check had no prefix hit or no copy-on-write")
    compare_logits(torch, k_lg, p_lg, "paged kernel route vs paged plain route", expect)
    compare_logits(torch, k_lg, d_lg, "paged kernel route vs dense kernel route", expect)
    del plain, k_lg, p_lg, d_lg
    gc.collect()
    torch.cuda.empty_cache()

    # preemption at full width: a tight pool, 12 requests
    tight = LLM(model, slots=8, max_len=max_len, cache_layout="paged", page_size=page,
                num_pages=1 + 100, prefix_cache=True, prefill_chunk=chunk, preempt=True)
    mid = order[20:44:2]
    pre_prompts = [prompts[i] for i in mid]
    pre_params = [dataclasses.replace(params[i], max_new=48) for i in mid]
    t0 = time.perf_counter()
    outs = tight.generate(pre_prompts, pre_params)
    c = tight.engine.health().counters
    a = tight.engine.alloc
    a.check_invariants()
    print(f"preemption: {len(pre_prompts)} requests of {sorted(len(p) for p in pre_prompts)} "
          f"prompt tokens on 8 slots and {a.num_pages - 1} pages: preempted {c['preempted']}, "
          f"resumed {c['resumed']}, finish reasons {sorted({o.finish_reason for o in outs})}, "
          f"free pages at the end {a.free_pages} of {a.num_pages - 1}, "
          f"{time.perf_counter() - t0:.1f} s")
    expect(c["preempted"] >= 1 and c["resumed"] == c["preempted"], "no preemption / resume")
    expect(all(o.finish_reason in ("length", "stop") for o in outs), "preempted run finish reasons")
    a.drop_cache()
    expect(a.free_pages == a.num_pages - 1, "pages leaked after the preempting run")
    del tight
    check(not failed, "paged generation phase: " + "; ".join(failed))
    return launches


class MoeLog:
    """Records each MoE layer call's row count and its (dropped, total)
    slots from the aux vector, by wrapping ``moe.moe_apply``; the records
    stay on the device until read."""

    def __init__(self, moe):
        self.moe, self.calls = moe, []

    def __enter__(self):
        apply, calls = self.moe.moe_apply, self.calls

        def spy(cfg, params, x):
            out, aux = apply(cfg, params, x)
            calls.append((x.shape[0] * x.shape[1], aux[2:4]))
            return out, aux

        self._apply, self.moe.moe_apply = apply, spy
        return self

    def __exit__(self, *exc):
        self.moe.moe_apply = self._apply


class RouteLog:
    """Wraps ``moe._route``.  Alone it records each call's router output
    (probs, expert indices).  With ``replay``, the records of another run
    of the same calls, it records this run's own output and returns the
    other run's experts instead (gates renormalized from this run's
    probabilities), so that both runs put every token on the same
    experts."""

    def __init__(self, moe, replay=None):
        self.moe, self.replay, self.calls = moe, replay, []

    def __enter__(self):
        route, calls, replay = self.moe._route, self.calls, self.replay

        def spy(cfg, params, x2d):
            probs, gate, idx = route(cfg, params, x2d)
            calls.append((probs, idx))
            if replay is None:
                return probs, gate, idx
            idx = replay[len(calls) - 1][1]
            gate = probs.gather(1, idx)
            return probs, gate / gate.sum(-1, keepdim=True).clamp_min(1e-9), idx

        self._route, self.moe._route = route, spy
        return self

    def __exit__(self, *exc):
        self.moe._route = self._route


def moe_phase(torch, counters, card):
    """Slice 5: Llama-4-Scout generation through ``LLM.generate`` over the
    dense KV cache, at full width with 8 of its 48 layers (39.4 GB of bf16
    weights), on the dense Qwen2 phase's load.  Returns the launch counts of
    the first generate call (the main path's run)."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.model import Model, build_model
    from repro_torch.serving.api import LLM
    from repro_torch.serving.engine import Request
    from repro_torch.serving.sampling import SamplingParams

    failed = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    cfg = dataclasses.replace(get_config("llama4-scout-17b-a16e"), num_layers=8,
                              param_dtype="bfloat16")
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t_build = time.perf_counter() - t0
    print(f"built {cfg.name} cut to {cfg.num_layers} of 48 layers (d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads, {cfg.num_experts} experts of d_ff {cfg.d_ff} "
          f"top-{cfg.num_experts_per_tok} + {cfg.n_shared_experts} shared, window "
          f"{cfg.sliding_window}, {cfg.param_count() / 1e9:.2f}B params, bf16) on cuda in "
          f"{t_build:.1f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    slots, max_len, n, max_new = 32, 2048, 64, 256
    rng = np.random.default_rng(0)
    lengths = rng.integers(64, 1025, size=n)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(L)).tolist() for L in lengths]
    params = [SamplingParams(max_new=max_new) if i % 2 == 0 else
              SamplingParams(temperature=0.8, top_k=50, top_p=0.95, seed=i, max_new=max_new,
                             logprobs=True) for i in range(n)]
    llm = LLM(model, slots=slots, max_len=max_len)
    eng = llm.engine
    L = cfg.num_layers
    names = ("flash_attention_fwd", "rmsnorm", "flash_decode", "fused_sample", "gmm")

    def zero():
        for name in names:
            counters[name].launches = 0

    def read():
        return {name: counters[name].launches for name in names}

    # the main path: every count set to 0 just before, read just after; the
    # router's drops recorded on the device meanwhile
    torch.cuda.reset_peak_memory_stats()
    log = MoeLog(moe)
    zero()
    dec0 = eng.decode_steps
    t0 = time.perf_counter()
    with log:
        first = llm.generate(prompts, params)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = read()
    n_dec = eng.decode_steps - dec0
    want = {"flash_attention_fwd": L * n, "rmsnorm": (2 * L + 1) * (n + n_dec),
            "flash_decode": L * n_dec, "fused_sample": n + n_dec, "gmm": 3 * L * (n + n_dec)}
    print(f"main path: LLM.generate of {n} prompts ({int(lengths.sum())} prompt tokens, "
          f"max_new {max_new}) on {slots} slots: {n} admissions, {n_dec} decode steps, "
          f"{t_first:.2f} s (first call, set-up included); launches {launches} (want {want})")
    expect(launches == want, "MoE generation launch counts")
    expect(len(log.calls) == L * (n + n_dec), "MoE layer calls")
    gen = [len(c.tokens) for c in first]
    expect(all(c.finish_reason == "length" for c in first) and gen == [max_new] * n,
           "finish reasons / lengths")
    expect(all(np.isfinite(c.logprobs).all() for c in first if c.logprobs), "non-finite logprobs")
    drops = {kind: torch.stack([a for rows, a in log.calls if (rows == slots) == dec]).sum(0).tolist()
             for kind, dec in (("decode", True), ("prefill", False))}
    print("router drops at capacity: " + ", ".join(
        f"{kind} {d:.0f} of {t:.0f} slots ({d / max(t, 1):.4f})" for kind, (d, t) in drops.items()) +
        f"; capacity {moe.capacity(cfg, slots)} per expert at decode ({slots} slots, idle ones "
        f"included), {moe.capacity(cfg, 64)}-{moe.capacity(cfg, 1024)} at prefill (64-1024 tokens)")
    del log

    t0 = time.perf_counter()
    second = llm.generate(prompts, params)
    torch.cuda.synchronize()
    t_steady = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    same = all(a.tokens == b.tokens and a.finish_reason == b.finish_reason
               for a, b in zip(first, second))
    print(f"second generate call: tokens and finish reasons identical: {same}")
    expect(same, "a repeated generate differs")
    ttft = sorted(c.ttft_s for c in second)
    toks = sum(len(c.tokens) for c in second)
    print(f"Llama-4-Scout (8 of 48 layers) LLM.generate on {card}: {toks / t_steady:.1f} generated "
          f"tokens/s ({toks} tokens in {t_steady:.3f} s, steady call), TTFT p50 "
          f"{1e3 * ttft[n // 2]:.1f} ms, p95 {1e3 * ttft[int(0.95 * (n - 1))]:.1f} ms, peak memory "
          f"{peak_gb:.2f} GB; build {t_build:.1f} s, first call {t_first:.2f} s")

    # the steady decode loop at full slots: per-step launches, no host sync
    # but the one transfer, the step time, and a profile
    for i in range(slots):
        eng.submit(Request(uid=20_000 + i, prompt=np.asarray(prompts[i], np.int32),
                           params=dataclasses.replace(params[i], max_new=64)))
    eng.step()                       # admits every slot, then decodes
    zero()
    eng.step()
    per_step = read()
    step_want = {"flash_attention_fwd": 0, "rmsnorm": 2 * L + 1, "flash_decode": L,
                 "fused_sample": 1, "gmm": 3 * L}
    print(f"one steady decode step: launches {per_step} (want {step_want})")
    expect(per_step == step_want, "launches per decode step")
    for _ in range(8):
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng.step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    print("8 steady decode steps under torch.cuda.set_sync_debug_mode('error'): no host sync "
          "outside the one transfer")
    t0 = time.perf_counter()
    for _ in range(16):
        eng.step()
    step_ms = (time.perf_counter() - t0) / 16 * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(8):
            eng.step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, groups, kern = kernel_groups(prof, DeviceType)
    print(f"Scout decode step of {slots} slots on {card}: {step_ms:.2f} ms "
          f"({slots / step_ms * 1e3:.0f} tokens/s at full slots)")
    if busy_ms == 0:
        print("profile: the profiler saw no device time")
    else:
        glue = groups["other"] + groups["rmsnorm"]
        print(f"profile of 8 Scout decode steps on {card}: wall {wall_ms:.1f} ms (under the "
              f"profiler), device busy {busy_ms:.1f} ms ({busy_ms / 8:.2f} ms a step), idle share "
              f"{1 - busy_ms / wall_ms:.3f}")
        print(f"profile by group, per step: gmm {groups['gmm'] / 8:.3f} ms, matmuls "
              f"{groups['matmul'] / 8:.3f} ms, glue {glue / 8:.3f} ms (rmsnorm "
              f"{groups['rmsnorm'] / 8:.3f}), flash_decode {groups['flash_decode'] / 8:.3f} ms, "
              f"sampling {groups['fused_sample'] / 8:.3f} ms")
        for name, t, cnt in sorted(kern, key=lambda r: -r[1])[:12]:
            print(f"  {t:9.2f} ms {cnt:6d}x  {name[:110]}")
        host = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CPU),
                      key=lambda e: -e.self_cpu_time_total)[:10]
        print("host time by op (self CPU ms, calls): " + ", ".join(
            f"{e.key} {e.self_cpu_time_total / 1e3:.1f} ({e.count})" for e in host))
    eng.run()
    del prof, llm, eng

    # kernel route against plain route through the engine: 8 prompts, the
    # first token's logits and 32 teacher-forced decode steps.  The plain
    # route is put on the kernel route's experts (RouteLog replay): top-1
    # routing of random weights flips at near-ties of the fp32 router over
    # hidden states that the two routes round differently, and a flipped
    # token moves the later ones through attention and capacity, so held
    # free the two routes drift apart on the routing, not on the kernels'
    # arithmetic.  The flips are counted from the plain route's own router,
    # and each must be a near-tie.
    picks = [int(i) for i in np.argsort(lengths)[:: n // 8]]
    n_forced = 32
    forced = torch.zeros((n_forced, slots), dtype=torch.int32, device=model.device)
    for slot, i in enumerate(picks):
        forced[:, slot] = torch.tensor(first[i].tokens[:n_forced], dtype=torch.int32)
    plain = Model(dataclasses.replace(cfg, kernel_impl="torch"), model.params.tree())
    route = dict(slots=slots, max_len=max_len)
    route_prompts = [prompts[i] for i in picks]
    with RouteLog(moe) as k_log:
        k_lg, _ = engine_logits(torch, np, model, route, route_prompts, forced)
    with RouteLog(moe, replay=k_log.calls) as p_log:
        p_lg, _ = engine_logits(torch, np, plain, route, route_prompts, forced)
    npk = len(route_prompts)
    check(len(k_log.calls) == len(p_log.calls) == L * (npk + n_forced), "route log lengths")
    # per layer call: the live rows (a whole prompt, or one row per live
    # slot), whether the plain route's own router chose another expert,
    # and the kernel route's log-probability margin of its choice over it
    flipped, margins, own = [], [], []
    for c, ((kp, ki), (_, pi)) in enumerate(zip(k_log.calls, p_log.calls)):
        rows = slice(None) if c < L * npk else slice(0, npk)
        kp, ki, pi = kp[rows], ki[rows], pi[rows]
        f = (ki != pi).any(-1)
        lp = kp.clamp_min(1e-30).log()
        margins.append(torch.where(f, lp.gather(1, ki[:, :1])[:, 0] - lp.gather(1, pi[:, :1])[:, 0],
                                   0.0).max())
        flipped.append(f)
        own.append(f[-1:] if c < L * npk else f)       # the compared token's row
    decisions = sum(f.numel() for f in flipped)
    n_flip = int(sum(f.sum() for f in flipped))
    margin = torch.stack(margins).max().item()
    pre = torch.stack(own[:L * npk]).reshape(npk, L).any(-1)
    dec = torch.stack(own[L * npk:]).reshape(n_forced, L, npk).any(1)
    slot_flips = torch.cat([pre[None], dec])                    # (1 + steps, npk)
    print(f"plain route's own router against the kernel route's experts: {n_flip} of {decisions} "
          f"router decisions (token x layer) differ ({n_flip / decisions:.4f}; limit 0.02), "
          f"largest kernel-route margin of such a choice {margin:.4f} in log-probability (a "
          f"near-tie: at most 0.1); {int(slot_flips.sum())} of {slot_flips.numel()} slot-steps "
          f"({slot_flips.float().mean().item():.4f}) have one in some layer of the compared token")
    expect(n_flip <= 0.02 * decisions, "the routes' routers disagree too often")
    expect(margin <= 0.1, "a routing difference between the routes is not a near-tie")
    compare_logits(torch, k_lg, p_lg,
                   f"Scout kernel path vs plain path through the engine on the same experts (8 "
                   f"slots of 32, prompts of {sorted(int(lengths[i]) for i in picks)} tokens, "
                   f"exact-length prefill + {n_forced} teacher-forced decode steps)", expect)
    del plain, model, k_lg, p_lg
    check(not failed, "MoE generation phase: " + "; ".join(failed))
    return launches


def ssm_phase(torch, counters, card):
    """Slice 6: Mamba2-2.7B generation at full width and depth through
    ``LLM.generate`` over the dense cache (exact-length prefills, the SSD
    state per slot), on the dense Qwen2 phase's load with ids within its
    vocab.  Returns the launch counts of the first generate call (the main
    path's run)."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, build_model
    from repro_torch.serving.api import LLM
    from repro_torch.serving.engine import Request
    from repro_torch.serving.sampling import SamplingParams

    failed = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    cfg = dataclasses.replace(get_config("mamba2-2.7b"), param_dtype="bfloat16")
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    print(f"built {cfg.name} ({cfg.num_layers} SSD layers, d_model {cfg.d_model}, {cfg.ssm_nheads} "
          f"heads of {cfg.ssm_headdim}, state {cfg.ssm_state}, {cfg.param_count() / 1e9:.2f}B "
          f"params, bf16) on cuda in {t_build:.1f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    slots, max_len, n, max_new = 32, 2048, 64, 256
    rng = np.random.default_rng(0)
    lengths = rng.integers(64, 1025, size=n)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(L)).tolist() for L in lengths]
    params = [SamplingParams(max_new=max_new) if i % 2 == 0 else
              SamplingParams(temperature=0.8, top_k=50, top_p=0.95, seed=i, max_new=max_new,
                             logprobs=True) for i in range(n)]
    llm = LLM(model, slots=slots, max_len=max_len)
    eng = llm.engine
    L = cfg.num_layers
    names = ("ssd_scan", "rmsnorm", "fused_sample", "flash_attention_fwd", "flash_decode")

    def zero():
        for name in names:
            counters[name].launches = 0

    def read():
        return {name: counters[name].launches for name in names}

    # the main path: every count set to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    zero()
    dec0 = eng.decode_steps
    t0 = time.perf_counter()
    first = llm.generate(prompts, params)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = read()
    n_dec = eng.decode_steps - dec0
    want = {"ssd_scan": L * n, "rmsnorm": (L + 1) * (n + n_dec), "fused_sample": n + n_dec,
            "flash_attention_fwd": 0, "flash_decode": 0}
    state_gb = sum(c["ssm"]["state"].numel() * 4 for c in eng.cache["layers"].values()) / 1e9
    print(f"main path: LLM.generate of {n} prompts ({int(lengths.sum())} prompt tokens at their "
          f"exact lengths, max_new {max_new}) on {slots} slots ({state_gb:.2f} GB of fp32 SSD "
          f"state): {n} admissions, {n_dec} decode steps, {t_first:.2f} s (first call, set-up "
          f"included); launches {launches} (want {want})")
    expect(launches == want, "Mamba2 generation launch counts")
    gen = [len(c.tokens) for c in first]
    expect(all(c.finish_reason == "length" for c in first) and gen == [max_new] * n,
           "finish reasons / lengths")
    expect(all(np.isfinite(c.logprobs).all() for c in first if c.logprobs), "non-finite logprobs")

    t0 = time.perf_counter()
    second = llm.generate(prompts, params)
    torch.cuda.synchronize()
    t_steady = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    same = all(a.tokens == b.tokens and a.finish_reason == b.finish_reason
               for a, b in zip(first, second))
    print(f"second generate call: tokens and finish reasons identical: {same}")
    expect(same, "a repeated generate differs")
    ttft = sorted(c.ttft_s for c in second)
    toks = sum(len(c.tokens) for c in second)
    print(f"Mamba2-2.7B LLM.generate on {card}: {toks / t_steady:.1f} generated tokens/s ({toks} "
          f"tokens in {t_steady:.3f} s, steady call), TTFT p50 {1e3 * ttft[n // 2]:.1f} ms, p95 "
          f"{1e3 * ttft[int(0.95 * (n - 1))]:.1f} ms, peak memory {peak_gb:.2f} GB; build "
          f"{t_build:.1f} s, first call {t_first:.2f} s")

    # the steady decode loop at full slots: per-step launches, no host sync
    # but the one transfer, the step time, and a profile
    for i in range(slots):
        eng.submit(Request(uid=30_000 + i, prompt=np.asarray(prompts[i], np.int32),
                           params=dataclasses.replace(params[i], max_new=64)))
    eng.step()                       # admits every slot, then decodes
    zero()
    eng.step()
    per_step = read()
    step_want = {"ssd_scan": 0, "rmsnorm": L + 1, "fused_sample": 1, "flash_attention_fwd": 0,
                 "flash_decode": 0}
    print(f"one steady decode step: launches {per_step} (want {step_want})")
    expect(per_step == step_want, "launches per decode step")
    for _ in range(8):
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng.step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    print("8 steady decode steps under torch.cuda.set_sync_debug_mode('error'): no host sync "
          "outside the one transfer")
    t0 = time.perf_counter()
    for _ in range(16):
        eng.step()
    step_ms = (time.perf_counter() - t0) / 16 * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(8):
            eng.step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, groups, kern = kernel_groups(prof, DeviceType)
    print(f"Mamba2 decode step of {slots} slots on {card}: {step_ms:.2f} ms "
          f"({slots / step_ms * 1e3:.0f} tokens/s at full slots)")
    if busy_ms == 0:
        print("profile: the profiler saw no device time")
    else:
        launches_per_step = sum(e.count for e in prof.key_averages()
                                if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                             "cudaLaunchKernelExC", "cuLaunchKernelEx")) / 8
        print(f"profile of 8 Mamba2 decode steps on {card}: wall {wall_ms:.1f} ms (under the "
              f"profiler), device busy {busy_ms:.1f} ms ({busy_ms / 8:.2f} ms a step), idle share "
              f"{1 - busy_ms / wall_ms:.3f}, {launches_per_step:.0f} kernel launches a step")
        print("profile by group, per step: " + ", ".join(
            f"{k} {v / 8:.3f} ms ({v / busy_ms:.1%})" for k, v in groups.items() if v))
        for name, t, cnt in sorted(kern, key=lambda r: -r[1])[:12]:
            print(f"  {t:9.2f} ms {cnt:6d}x  {name[:110]}")
        host = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CPU),
                      key=lambda e: -e.self_cpu_time_total)[:10]
        print("host time by op (self CPU ms, calls): " + ", ".join(
            f"{e.key} {e.self_cpu_time_total / 1e3:.1f} ({e.count})" for e in host))
    eng.run()
    del prof, llm, eng

    try:
        LLM(model, slots=2, max_len=64, cache_layout="paged")
        refused = False
    except ValueError as err:
        refused = True
        print(f"the paged layout is refused for {cfg.name}: {err}")
    expect(refused, "the engine took cache_layout='paged' for an SSM model")

    # kernel route against plain route (kernel_impl="torch", the same
    # weights) through the engine: exact-length prefills into 8 of 32
    # slots, then lockstep decode steps, teacher-forced with the main run's
    # tokens.  64 random-weight layers amplify bf16 rounding: two plain
    # routes that differ only in the scan's fp32 summation order (chunks of
    # 64 and 128) part to a cosine of ~0.9984 (ssd_route_faults.py), below
    # the 0.999 that holds the shallower models, so the routes are held to
    # an fp32-compute route (the same bf16 weights, fp32 activations) and
    # the kernel route must come as close to it as the plain route does.
    # That catches a gross fault (D·x dropped) but not one of a few bf16
    # steps a layer (ssd_route_faults.py plants both): the gate for those
    # is ssm_layer_check, which holds each SSD layer on its real input.
    picks = [int(i) for i in np.argsort(lengths)[:: n // 8]]
    n_forced = 32
    forced = torch.zeros((n_forced, slots), dtype=torch.int32, device=model.device)
    for slot, i in enumerate(picks):
        forced[:, slot] = torch.tensor(first[i].tokens[:n_forced], dtype=torch.int32)
    route = dict(slots=slots, max_len=max_len)
    route_prompts = [prompts[i] for i in picks]
    logits = {"kernel": engine_logits(torch, np, model, route, route_prompts, forced)[0]}
    for name, over in (("plain", dict(kernel_impl="torch")),
                       ("fp32", dict(kernel_impl="torch", dtype="float32"))):
        other = Model(dataclasses.replace(cfg, **over), model.params.tree())
        logits[name] = engine_logits(torch, np, other, route, route_prompts, forced)[0]
        del other
    anchored_compare(torch, logits, route_label(lengths, picks, n_forced), expect)
    plain_cfg = dataclasses.replace(cfg, kernel_impl="torch")
    ssm_layer_check(torch, model, plain_cfg, prompts[picks[-1]], expect)
    del model, logits
    check(not failed, "Mamba2 generation phase: " + "; ".join(failed))
    return launches


def route_label(lengths, picks, n_forced):
    return (f"Mamba2 routes through the engine (8 slots of 32, prompts of "
            f"{sorted(int(lengths[i]) for i in picks)} tokens, exact-length prefill + "
            f"{n_forced} teacher-forced decode steps)")


def anchored_compare(torch, logits, label, expect):
    """Hold the kernel route to the plain route through an fp32-compute
    route, for a model deep enough that bf16 rounding alone moves its
    logits past the 0.999 cosine of ``compare_logits``: the kernel route
    must be as close to the fp32 route as the plain route is (its mean
    1 − cosine at most 1.25× the plain route's, its least cosine within
    0.001 of the plain route's least), and agree with the fp32 route's
    top-1 wherever that route's top-2 gap exceeds the slot-step's max
    |Δlogit|.  Catches a gross fault of the kernel; one that moves a layer
    by a few bf16 steps reads as the sound kernel does, and is left to
    ``ssm_layer_check`` (``ssd_route_faults.py``).  Prints the
    kernel-vs-plain cosine; returns the readings."""
    def cos(a, b):
        return torch.nn.functional.cosine_similarity(logits[a], logits[b], dim=-1)

    kp = cos("kernel", "plain")
    kf, pf = cos("kernel", "fp32"), cos("plain", "fp32")
    f = logits["fp32"]
    dmax = (logits["kernel"] - f).abs().amax(dim=-1)
    top2 = f.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > dmax
    agree = logits["kernel"].argmax(-1) == f.argmax(-1)
    print(f"{label}: kernel vs plain cosine min {kp.min().item():.6f} (first tokens "
          f"{kp[0].min().item():.6f}); against the fp32 route: "
          f"kernel min {kf.min().item():.6f}, mean 1-cos {(1 - kf).mean().item():.3g}; plain min "
          f"{pf.min().item():.6f}, mean 1-cos {(1 - pf).mean().item():.3g}; kernel top-1 = fp32 "
          f"top-1 on {int((agree & decided).sum())} of {int(decided.sum())} decided slot-steps")
    expect((1 - kf).mean().item() <= 1.25 * (1 - pf).mean().item(),
           f"{label}: the kernel route is further from the fp32 route than the plain route")
    expect(kf.min().item() >= pf.min().item() - 1e-3,
           f"{label}: the kernel route's least cosine to the fp32 route is below the plain route's")
    expect(bool(agree[decided].all()), f"{label}: top-1 differs from the fp32 route where decided")
    return {"kernel_plain_min": kp.min().item(), "kernel_fp32_min": kf.min().item(),
            "plain_fp32_min": pf.min().item(), "kernel_fp32_mean": (1 - kf).mean().item(),
            "plain_fp32_mean": (1 - pf).mean().item(),
            "top1": f"{int((agree & decided).sum())}/{int(decided.sum())}"}


def ssm_layer_check(torch, model, plain_cfg, prompt, expect):
    """Every SSD layer of the kernel route's prefill of ``prompt`` against
    the plain route on the same input (the layer's real activations): the
    output within 2 bf16 steps of each row's max|plain|, the final state
    within 1e-4 of each head's max|plain|."""
    from repro_torch.models import ssm
    from repro_torch.models import transformer as T

    seen, apply = [], T.ssm_apply

    def spy(cfg, params, x, *, mode="train", cache=None):
        out, c = apply(cfg, params, x, mode=mode, cache=cache)
        seen.append((params, x, out, c))
        return out, c

    T.ssm_apply = spy
    try:
        model.prefill(model.params.tree(), {"tokens": torch.tensor([prompt], device=model.device)},
                      len(prompt))
    finally:
        T.ssm_apply = apply
    worst_steps, worst_state = 0.0, 0.0
    for params, x, out, c in seen:
        want, wc = ssm.ssm_apply(plain_cfg, params, x, mode="prefill")
        top = want.float().abs().amax(-1, keepdim=True).clamp_min(1e-30)
        step = torch.exp2(torch.floor(torch.log2(top)) - 7)
        worst_steps = max(worst_steps, ((out.float() - want.float()).abs() / step).max().item())
        worst_state = max(worst_state, row_rel_err(c["state"], wc["state"], dims=2))
    print(f"each of the {len(seen)} SSD layers on its real input ({len(prompt)} tokens): kernel "
          f"route's output within {worst_steps:.3g} bf16 steps of each row's max|plain| (tol 2), "
          f"final state within {worst_state:.3g} of each head's max|plain| (tol 1e-4)")
    expect(worst_steps <= 2 and worst_state <= 1e-4, "an SSD layer differs from its plain route")
    return worst_steps, worst_state


def hybrid_phase(torch, counters, card):
    """The hybrid unit on the card at reduced size: ``reduced()``
    Jamba-1.5-Large in bf16 (one unit of 8 layers: 7 SSD layers and one
    attention layer, MoE top-2 on every other layer) through one
    ``LLM.generate`` of a few prompts, every sublayer kind's kernel
    counted, a repeat's tokens, and the kernel route against the plain
    route on the kernel route's experts.  The full model does not fit one
    card (one unit is ~90 GB in bf16)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.config import reduced
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.models.model import Model, build_model
    from repro_torch.serving.api import LLM
    from repro_torch.serving.sampling import SamplingParams

    failed = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    cfg = reduced(get_config("jamba-1.5-large-398b"), dtype="bfloat16", param_dtype="bfloat16")
    model = build_model(cfg, seed=0)
    L = cfg.num_layers
    n_ssm = sum(not cfg.is_attn_layer(i) for i in range(L))
    n_moe = T.num_moe_layers(cfg)
    rng = np.random.default_rng(1)
    lengths = rng.integers(20, 200, size=6)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist() for n in lengths]
    params = [SamplingParams(max_new=16) if i % 2 == 0 else
              SamplingParams(temperature=0.8, top_k=20, seed=i, max_new=16) for i in range(6)]
    llm = LLM(model, slots=4, max_len=256)
    names = ("ssd_scan", "flash_attention_fwd", "flash_decode", "gmm", "rmsnorm", "fused_sample")
    for name in names:
        counters[name].launches = 0
    dec0 = llm.engine.decode_steps
    first = llm.generate(prompts, params)
    torch.cuda.synchronize()
    launches = {name: counters[name].launches for name in names}
    n, n_dec = len(prompts), llm.engine.decode_steps - dec0
    want = {"ssd_scan": n_ssm * n, "flash_attention_fwd": (L - n_ssm) * n,
            "flash_decode": (L - n_ssm) * n_dec, "gmm": 3 * n_moe * (n + n_dec),
            "rmsnorm": (2 * L + 1) * (n + n_dec), "fused_sample": n + n_dec}
    print(f"reduced {cfg.name} (bf16, {L} layers: {n_ssm} SSD + {L - n_ssm} attention, {n_moe} MoE "
          f"top-{cfg.num_experts_per_tok} of {cfg.num_experts}, d_model {cfg.d_model}) "
          f"LLM.generate of {n} prompts ({sorted(int(x) for x in lengths)} tokens) on 4 slots: "
          f"{n_dec} decode steps; launches {launches} (want {want})")
    expect(launches == want, "hybrid launch counts")
    expect([len(c.tokens) for c in first] == [16] * n, "hybrid lengths")
    again = llm.generate(prompts, params)
    same = all(a.tokens == b.tokens for a, b in zip(first, again))
    print(f"a repeated call's tokens identical: {same}")
    expect(same, "a repeated hybrid generate differs")
    del llm

    forced = torch.zeros((8, 4), dtype=torch.int32, device=model.device)
    for slot in range(4):
        forced[:, slot] = torch.tensor(first[slot].tokens[:8], dtype=torch.int32)
    plain = Model(dataclasses.replace(cfg, kernel_impl="torch"), model.params.tree())
    with RouteLog(moe) as k_log:
        k_lg, _ = engine_logits(torch, np, model, dict(slots=4, max_len=256), prompts[:4], forced)
    with RouteLog(moe, replay=k_log.calls):
        p_lg, _ = engine_logits(torch, np, plain, dict(slots=4, max_len=256), prompts[:4], forced)
    compare_logits(torch, k_lg, p_lg,
                   "reduced Jamba kernel path vs plain path through the engine on the same experts "
                   "(4 slots, exact-length prefill + 8 teacher-forced decode steps)", expect)
    del plain, model
    check(not failed, "hybrid phase: " + "; ".join(failed))


def moe_train_phase(torch, counters, card):
    """Slice 5b: Llama-4-Scout MoE training through ``Trainer.run`` at full
    width with 1 of its 48 layers (4.27 B parameters: fp32 master weights,
    bf16 AdamW moments), on packed synthetic protein batches of 2 x 1024
    tokens.  Before the trainer builds its optimizer state, one
    micro-batch's loss and gradients are computed twice on the kernel
    route (bit-identical) and once on the plain route put on the kernel
    route's experts (loss within 2e-2, every leaf's cosine >= 0.999).
    Returns the launch counts of the trainer's run (the main path's)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.config import ParallelConfig, TrainConfig
    from repro_torch.core.module import tree_leaves
    from repro_torch.core.precision import compute_view
    from repro_torch.data.dataset import build_synthetic_protein_memmap
    from repro_torch.data.pipeline import CLMBatches
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.models.model import Model, build_model
    from repro_torch.training.loop import Trainer
    from repro_torch.training.train_step import make_train_step

    failed = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    free, total_mem = torch.cuda.mem_get_info()
    print(f"MoE training phase: {free / 1e9:.2f} GB free of {total_mem / 1e9:.2f} GB at its start")
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config("llama4-scout-17b-a16e"), num_layers=1)
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0)
    torch.cuda.synchronize()
    print(f"built {cfg.name} cut to {cfg.num_layers} of 48 layers at full width (d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, {cfg.num_experts} experts of "
          f"d_ff {cfg.d_ff} top-{cfg.num_experts_per_tok} + {cfg.n_shared_experts} shared, vocab "
          f"{cfg.vocab_size}, {cfg.param_count() / 1e9:.3f}B params, fp32 master weights) in "
          f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    B, seq, steps = 2, 1024, 6
    tc = TrainConfig(global_batch=B, seq_len=seq, accum_steps=1, learning_rate=3e-4, min_lr=3e-5,
                     warmup_steps=2, decay_steps=2, total_steps=steps, schedule="wsd",
                     weight_decay=0.01, grad_clip=1.0, log_every=steps)
    tmp = tempfile.TemporaryDirectory()
    ds, tok = build_synthetic_protein_memmap(f"{tmp.name}/prot", n=1024, seed=0)
    print(f"training data: {len(ds)} synthetic sequences of 40-199 residues, packed with <eos> "
          f"into {B} x {seq} tokens a step (capacity {moe.capacity(cfg, B * seq)} an expert), "
          f"AdamW with bf16 moments + WSD, peak lr {tc.learning_rate}, {steps} steps")

    # ---- repeat and routes on one micro-batch, before any optimizer state
    batch = {k: torch.from_numpy(v).to(model.device)
             for k, v in next(iter(CLMBatches(ds, B, seq, seed=1, eos_id=tok.eos_id))).items()}
    plain = Model(dataclasses.replace(cfg, kernel_impl="torch"), model.params.tree())
    names = leaf_paths(model.params.tree())

    def loss_grads(m):
        p = m.params.tree()
        loss, _ = m.loss_fn(compute_view(m.policy, p), batch)
        return loss.item(), torch.autograd.grad(loss, tree_leaves(p))

    with RouteLog(moe) as k_log:
        k_loss, k_grads = loss_grads(model)
    again_loss, again = loss_grads(model)
    differ = [names[i] for i, (a, b) in enumerate(zip(k_grads, again)) if not torch.equal(a, b)]
    print(f"kernel route twice on one micro-batch: loss {k_loss!r} vs {again_loss!r}; "
          f"{len(differ)} of {len(names)} grad leaves differ {differ[:6]}")
    expect(k_loss == again_loss and not differ, "a repeated loss and backward is not bit-identical")
    del again
    with RouteLog(moe, replay=k_log.calls) as p_log:
        p_loss, p_grads = loss_grads(plain)
    cos = [cosine(torch, a, b) for a, b in zip(k_grads, p_grads)]
    own = p_log.calls[0][1][:, 0]            # the plain router's own choice
    flips = int((own != k_log.calls[0][1][:, 0]).sum())
    worst = min(range(len(cos)), key=lambda i: cos[i])
    print(f"kernel route vs plain route on the kernel route's experts (loss_fn + backward, "
          f"{B}x{seq}): loss {k_loss:.6f} vs {p_loss:.6f} (|diff| {abs(k_loss - p_loss):.3g}, tol "
          f"2e-2); grad cosine min {cos[worst]:.6f} ({names[worst]}, of {len(cos)} leaves; floor "
          f"0.999), mean {statistics.mean(cos):.6f}; the plain router alone would move {flips} of "
          f"{own.numel()} tokens")
    print("lowest grad cosines: " + ", ".join(
        f"{names[i]} {cos[i]:.6f}" for i in sorted(range(len(cos)), key=lambda i: cos[i])[:5]))
    expect(abs(k_loss - p_loss) <= 2e-2, "kernel route loss disagrees with the plain route")
    expect(min(cos) >= 0.999, "kernel route gradients disagree with the plain route")
    del k_grads, p_grads, plain, k_log, p_log
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the main path: Trainer.run
    pipe = CLMBatches(ds, B, seq, seed=0, eos_id=tok.eos_id)
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    trainer = Trainer(model, tc, pc=ParallelConfig(optimizer_state_dtype="bfloat16"),
                      peak_flops=PEAK_BF16_FLOPS)
    state, hist = trainer.run(pipe)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_moe = T.num_moe_layers(cfg)
    want = dict.fromkeys(counters, 0)
    want.update(flash_attention_fwd=steps, flash_attention_bwd=steps,
                rmsnorm=(2 * cfg.num_layers + 1) * steps, cross_entropy_fwd=steps,
                cross_entropy_bwd=steps, gmm=6 * n_moe * steps, gmm_dw=3 * n_moe * steps)
    print(f"main path: Trainer.run of {steps} steps: launches {launches} (want {want})")
    losses = [h["loss"] for h in hist]
    print(f"losses: step 0 {losses[0]:.4f} (ce {hist[0]['ce_loss']:.4f}), step {steps - 1} "
          f"{losses[-1]:.4f} (ce {hist[-1]['ce_loss']:.4f}); router at step {steps - 1}: lb "
          f"{hist[-1]['aux_loss']:.4f}, entropy {hist[-1]['router_entropy']:.4f}, drop fraction "
          f"{hist[-1]['router_drop_frac']:.4f}")
    expect(len(hist) == 2 and all(x == x and abs(x) < 1e30 for x in losses), "non-finite loss")
    expect(trainer.skipped_total == 0, f"{trainer.skipped_total} skipped steps")
    expect(losses[-1] < losses[0], "the loss did not fall")
    expect(launches == want, "MoE training launch counts")
    step_s = hist[-1]["step_time"]
    tokens = B * seq
    mfu = 6 * cfg.active_param_count() * tokens / step_s / PEAK_BF16_FLOPS
    print(f"Llama-4-Scout (1 of 48 layers) MoE training on {card}: step {step_s * 1e3:.1f} ms "
          f"(wall of steps 1-{steps - 1} over {steps - 1}, one host transfer; step 0 with its "
          f"transfer {hist[0]['step_time'] * 1e3:.1f} ms), {tokens / step_s:.0f} tokens/s, MFU "
          f"{mfu:.4f} (6 x {cfg.active_param_count() / 1e9:.3f}B active params x tokens / 989 "
          f"TFLOP/s), peak memory {peak_gb:.2f} GB of {total_mem / 1e9:.2f} GB")

    # where the time goes: one more optimizer step under the profiler
    batch = {k: torch.from_numpy(v).to(model.device) for k, v in next(iter(pipe)).items()}
    step_fn = make_train_step(model, tc)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, groups, kern = kernel_groups(prof, DeviceType)
    if busy_ms == 0:
        print("profile: the profiler saw no device time")
    else:
        print(f"profile of one MoE train step on {card}: wall {wall_ms:.1f} ms (under the "
              f"profiler), device busy {busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
        print("profile by group (other = glue with clip and AdamW): " + ", ".join(
            f"{k} {v:.1f} ms ({v / busy_ms:.1%})" for k, v in groups.items() if v))
        for name, t, cnt in sorted(kern, key=lambda r: -r[1])[:14]:
            print(f"  {t:9.2f} ms {cnt:6d}x  {name[:110]}")
    del trainer, state, model, step_fn, prof, batch
    tmp.cleanup()
    gc.collect()
    torch.cuda.empty_cache()
    check(not failed, "MoE training phase: " + "; ".join(failed))
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU", file=sys.stderr)
        return 2

    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.data.tokenizer import ProteinTokenizer
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.cross_entropy import cross_entropy_bwd, cross_entropy_fwd
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.grouped_matmul import gmm, gmm_dw
    from repro_torch.kernels.paged_attention import paged_decode, paged_kv_write, paged_prefill
    from repro_torch.kernels.rmsnorm import layernorm, rmsnorm
    from repro_torch.kernels.sampling import fused_sample
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models.model import Model, build_model
    from repro_torch.obs.trace import TraceRecorder
    from repro_torch.serving.api import LLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. the card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # ---- 2. build every kernel: one nvcc per CUDA source, all started
    # together; the Triton norm compiles at its first launch
    t0 = time.perf_counter()
    logs = _build.finish_builds(_build.start_builds(
        ["flash_attention_fwd", "flash_attention_bwd", "cross_entropy", "flash_decode", "sampling",
         "paged_attention", "grouped_matmul", "ssd_scan"]))
    t_nvcc = time.perf_counter() - t0
    for name, log in logs.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill stores" in ln
                and not ln.strip().startswith("0 bytes")]
        print(f"built {name} in {t_nvcc:.1f} s: " + " | ".join(regs))
    t0 = time.perf_counter()
    xw = torch.ones(8, 1280, device=dev, dtype=torch.bfloat16)
    layernorm(xw, torch.ones(1280, device=dev), torch.zeros(1280, device=dev))
    rmsnorm(xw, torch.ones(1280, device=dev))
    torch.cuda.synchronize()
    print(f"compiled layernorm and rmsnorm (Triton) in {time.perf_counter() - t0:.1f} s")

    # ---- 3. each kernel against its plain version, on the card
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=g, device=dev) * scale + shift).to(dtype)

    # tolerances, for unit-normal inputs: the kernel rounds P to the input
    # dtype before PV (<= 2^-9 relative per probability in bf16) and both
    # round the output once; lse is fp32 from the same fp32 scores
    fa_tol = {torch.bfloat16: 3e-2, torch.float16: 4e-3}
    lse_tol = 1e-4
    fa_cases = [
        ("esm2-650m serving shape", dict(B=32, S=1024, T=1024, H=20, Hkv=20, D=64), dict(causal=False)),
        # the generation prefill: batch 1, a power-of-2 bucket, GQA group 7
        ("qwen2-7b prefill, largest bucket", dict(B=1, S=1024, T=1024, H=28, Hkv=4, D=128),
         dict(causal=True)),
        ("qwen2-7b prefill, smallest bucket", dict(B=1, S=64, T=64, H=28, Hkv=4, D=128),
         dict(causal=True)),
        ("causal", dict(B=2, S=128, T=128, H=4, Hkv=4, D=64), dict(causal=True)),
        ("causal window", dict(B=2, S=200, T=200, H=4, Hkv=4, D=64), dict(causal=True, window=48)),
        ("softcap", dict(B=2, S=96, T=96, H=4, Hkv=4, D=64), dict(causal=False, softcap=20.0)),
        ("gqa H=8 Hkv=2", dict(B=2, S=128, T=128, H=8, Hkv=2, D=64), dict(causal=True)),
        ("D=128", dict(B=2, S=128, T=128, H=4, Hkv=4, D=128), dict(causal=False)),
        ("non-multiple S/T", dict(B=3, S=77, T=131, H=4, Hkv=4, D=64), dict(causal=False)),
        ("q_offset", dict(B=2, S=40, T=104, H=4, Hkv=2, D=128), dict(causal=True, q_offset=64)),
        ("fully-masked rows", dict(B=1, S=24, T=24, H=2, Hkv=2, D=64), dict(causal=True, q_offset=-8)),
    ]
    fa_serving_err = 0.0
    for label, s, kw in fa_cases:
        for dt in (torch.bfloat16, torch.float16):
            q = randn(s["B"], s["S"], s["H"], s["D"], dtype=dt)
            k = randn(s["B"], s["T"], s["Hkv"], s["D"], dtype=dt)
            v = randn(s["B"], s["T"], s["Hkv"], s["D"], dtype=dt)
            out, lse = flash_attention_fwd(q, k, v, **kw)
            torch.cuda.synchronize()
            r_out, r_lse = ref.attention_ref(q, k, v, **kw)
            e_out = (out.float() - r_out.float()).abs().max().item()
            e_lse = (lse - r_lse).abs().max().item()
            print(f"flash_attention_fwd {label} {str(dt)[6:]}: out err {e_out:.3g} "
                  f"(tol {fa_tol[dt]}), lse err {e_lse:.3g} (tol {lse_tol})")
            check(e_out <= fa_tol[dt] and e_lse <= lse_tol, f"flash_attention_fwd {label} {dt}")
            if label.startswith("esm2") and dt == torch.bfloat16:
                fa_serving_err = e_out

    B, S, H, D = 32, 1024, 20, 64
    q, k, v = (randn(B, S, H, D) for _ in range(3))
    fa_ms = time_ms(torch, lambda: flash_attention_fwd(q, k, v, causal=False))
    fa_dev_ms = device_ms(torch, lambda: flash_attention_fwd(q, k, v, causal=False), "flash_attention_fwd")
    fa_plain_ms = time_ms(torch, lambda: ref.attention_ref(q, k, v, causal=False))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    fa_lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt))
    fa_flops = 4 * B * H * S * S * D
    fa_bound_ms, fa_bound_by = bound(fa_flops, 4 * B * S * H * D * 2 + B * H * S * 4)
    print(f"flash_attention_fwd B={B} S=T={S} H={H} D={D} bf16 on {card}: {fa_ms:.4f} ms "
          f"(device {fmt_ms(fa_dev_ms)} ms; bound {fa_bound_ms:.4f} ms by {fa_bound_by}, "
          f"{fa_flops / fa_ms / 1e9:.1f} TFLOP/s), plain {fa_plain_ms:.4f} ms, "
          f"scaled_dot_product_attention {fa_lib_ms:.4f} ms")
    # the same kernel at the generation prefill's largest bucket
    S, H, Hkv, D = 1024, 28, 4, 128
    q = randn(1, S, H, D)
    k, v = randn(1, S, Hkv, D), randn(1, S, Hkv, D)
    pf_ms = time_ms(torch, lambda: flash_attention_fwd(q, k, v, causal=True))
    pf_dev_ms = device_ms(torch, lambda: flash_attention_fwd(q, k, v, causal=True), "flash_attention_fwd")
    pf_plain_ms = time_ms(torch, lambda: ref.attention_ref(q, k, v, causal=True))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    pf_lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                                      enable_gqa=True))
    pf_flops = 4 * H * D * S * (S + 1) // 2          # the causal half of QK^T and PV
    pf_bound_ms, pf_bound_by = bound(pf_flops, (2 * S * H * D + 2 * S * Hkv * D) * 2 + S * H * 4)
    print(f"flash_attention_fwd qwen2-7b prefill B=1 S=T={S} H={H} Hkv={Hkv} D={D} causal bf16 on "
          f"{card}: {pf_ms:.4f} ms (device {fmt_ms(pf_dev_ms)} ms; bound {pf_bound_ms:.4f} ms by "
          f"{pf_bound_by}), plain {pf_plain_ms:.4f} ms, scaled_dot_product_attention (causal, "
          f"GQA) {pf_lib_ms:.4f} ms")
    del q, k, v, qt, kt, vt

    rows, d = 32 * 1024, 1280
    ln_serving_err = 0.0
    for dt in (torch.bfloat16, torch.float32):
        for bias in (True, False):
            x = randn(rows, d, dtype=dt, scale=3.0, shift=1.0)
            w = randn(d, dtype=torch.float32)
            b = randn(d, dtype=torch.float32) if bias else None
            y = layernorm(x, w, b)
            torch.cuda.synchronize()
            r = ref.layernorm_ref(x, w, b)
            err = (y.float() - r.float()).abs()
            # bf16: at most one output rounding step (2^-8 relative, at most
            # 2^-7 of |y|); fp32: moments summed in another order
            if dt == torch.bfloat16:
                ok = bool((err <= 1e-2 + 2**-7 * r.float().abs()).all())
                tol = "1e-2 + 2^-7*|y|"
            else:
                ok = err.max().item() <= 1e-4
                tol = "1e-4"
            print(f"layernorm ({rows}, {d}) {str(dt)[6:]} bias={bias}: err {err.max().item():.3g} (tol {tol})")
            check(ok, f"layernorm {dt} bias={bias}")
            if dt == torch.bfloat16 and bias:
                ln_serving_err = err.max().item()
    x = randn(rows, d)
    w, b = randn(d, dtype=torch.float32), randn(d, dtype=torch.float32)
    wl, bl = w.to(torch.bfloat16), b.to(torch.bfloat16)
    ln_ms = time_ms(torch, lambda: layernorm(x, w, b))
    ln_dev_ms = device_ms(torch, lambda: layernorm(x, w, b), "layernorm")
    ln_plain_ms = time_ms(torch, lambda: ref.layernorm_ref(x, w, b))
    ln_lib_ms = time_ms(torch, lambda: F.layer_norm(x, (d,), wl, bl, 1e-5))
    ln_bound_ms, ln_bound_by = bound(8 * rows * d, 2 * rows * d * 2 + 2 * d * 4, PEAK_FP32_FLOPS)
    print(f"layernorm ({rows}, {d}) bf16 on {card}: {ln_ms:.4f} ms (device {fmt_ms(ln_dev_ms)} ms; "
          f"bound {ln_bound_ms:.4f} ms by {ln_bound_by}, "
          f"{(2 * rows * d * 2 + 2 * d * 4) / ln_ms / 1e6:.0f} GB/s), plain {ln_plain_ms:.4f} ms, "
          f"F.layer_norm {ln_lib_ms:.4f} ms")
    del x

    fa_bwd_rec = check_attention_bwd(torch, F, ref, flash_attention_fwd, flash_attention_bwd,
                                     randn, card)
    ce_recs = check_cross_entropy(torch, F, ref, cross_entropy_fwd, cross_entropy_bwd, randn, g, card)
    gen_recs = [check_rmsnorm(torch, F, ref, rmsnorm, randn, card),
                check_sampling(torch, ref, fused_sample, randn, card),
                check_flash_decode(torch, F, ref, flash_decode, randn, card)]
    paged_recs = [check_paged_decode(torch, F, ref, paged_decode, randn, card),
                  check_paged_prefill(torch, F, ref, paged_prefill, randn, card),
                  check_paged_kv_write(torch, ref, paged_kv_write, randn, card)]
    gmm_rec = check_gmm(torch, ref, gmm, card)
    gmm_dw_rec = check_gmm_dw(torch, ref, gmm, gmm_dw, card)
    ssd_rec = check_ssd_scan(torch, ref, ssd_scan, card)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 4. slice 1: ESM-2 650M embedding serving through LLM.embed
    cfg = get_config("esm2-650m")
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    print(f"built {cfg.name} ({cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.param_count() / 1e6:.0f}M params) on cuda in {time.perf_counter() - t0:.1f} s")
    tok = ProteinTokenizer()
    rng = np.random.default_rng(0)
    n = 96
    lengths = rng.integers(30, 1023, size=n)          # tokens incl. <cls> and <eos>
    prompts = [tok.encode("".join(rng.choice(list(AMINO_ACIDS), size=int(L) - 2))) for L in lengths]
    trace = TraceRecorder()
    llm = LLM(model, slots=32, max_len=1024, trace=trace)

    flash_attention_fwd.launches = 0
    layernorm.launches = 0
    trace.clear()
    t0 = time.perf_counter()
    vecs = llm.embed(prompts)
    t_first = time.perf_counter() - t0
    launches = {"flash_attention_fwd": flash_attention_fwd.launches, "layernorm": layernorm.launches}
    buckets = [e["bucket"] for e in trace.events() if e["event"] == "prefill"]
    dispatches = len(buckets)
    print(f"main path: LLM.embed of {n} prompts, {dispatches} dispatches over buckets "
          f"{sorted(set(buckets))}: launches {launches} "
          f"(want {33 * dispatches} and {67 * dispatches})")
    check(vecs.shape == (n, cfg.d_model) and vecs.dtype == np.float32, f"shape {vecs.shape} {vecs.dtype}")
    check(bool(np.isfinite(vecs).all()), "non-finite embeddings")
    check(launches["flash_attention_fwd"] == 33 * dispatches, "attention launches")
    check(launches["layernorm"] == 67 * dispatches, "layernorm launches")

    t0 = time.perf_counter()
    again = llm.embed(prompts)
    t_steady = time.perf_counter() - t0
    check(np.array_equal(vecs, again), "second embed call differs")
    print("second call: bit-identical")

    alone = np.stack([llm.embed([prompts[i]])[0] for i in (0, 1, 2, 3)])
    e_alone = float(np.abs(alone - vecs[:4]).max())
    # every dispatch has the same (slots, bucket) shape, so a row's result
    # should not move with its batch mates; 1e-4 leaves room for a GEMM
    # that splits its work by batch
    print(f"batch-composition independence: max |alone - together| {e_alone:.3g} (tol 1e-4)")
    check(e_alone <= 1e-4, "embedding depends on batch mates")

    plain_model = Model(dataclasses.replace(cfg, kernel_impl="torch"), model.params.tree())
    t0 = time.perf_counter()
    plain = LLM(plain_model, slots=32, max_len=1024).embed(prompts)
    t_plain = time.perf_counter() - t0
    cos = (vecs * plain).sum(1) / (np.linalg.norm(vecs, axis=1) * np.linalg.norm(plain, axis=1))
    print(f"kernel path vs plain path: min cosine {cos.min():.7f} (tol >= 0.9999), "
          f"max abs diff {np.abs(vecs - plain).max():.3g}, plain path {t_plain:.2f} s")
    check(bool((cos >= 0.9999).all()), "kernel path disagrees with the plain path")
    del plain_model

    real_tokens = int(lengths.sum())
    padded_tokens = 32 * sum(buckets)
    print(f"ESM-2 650M LLM.embed on {card}: {n / t_steady:.1f} sequences/s, "
          f"{real_tokens / t_steady:.0f} tokens/s ({padded_tokens / t_steady:.0f} padded tokens/s; "
          f"{n} sequences, {real_tokens} tokens, {t_steady:.3f} s; first call {t_first:.3f} s)")

    # ---- 5. where the embed time goes: one more call under the profiler
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        llm.embed(prompts)
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, groups, kern = kernel_groups(prof, DeviceType)
    if busy_ms == 0:
        print("profile: the profiler saw no device time")
    else:
        print(f"profile of one embed call on {card}: wall {wall_ms:.1f} ms (under the profiler), "
              f"device busy {busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
        print("profile by group: " + ", ".join(
            f"{k} {v:.1f} ms ({v / busy_ms:.1%})" for k, v in groups.items() if v))
        for name, t, cnt in sorted(kern, key=lambda r: -r[1])[:12]:
            print(f"  {t:9.2f} ms {cnt:6d}x  {name[:110]}")
    del llm, prof

    # ---- 6. slice 2: ESM-2 650M MLM pre-training through Trainer.run
    counters = {"flash_attention_fwd": flash_attention_fwd, "flash_attention_bwd": flash_attention_bwd,
                "layernorm": layernorm, "cross_entropy_fwd": cross_entropy_fwd,
                "cross_entropy_bwd": cross_entropy_bwd}
    train_launches = train_phase(torch, model, counters, card)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 7. slice 4a: Qwen2-7B generation through LLM.generate
    counters.update(rmsnorm=rmsnorm, flash_decode=flash_decode, fused_sample=fused_sample)
    gen_launches, model, load = generate_phase(torch, counters, card)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 8. slice 4b: the same model and load through the paged KV cache
    counters.update(paged_decode=paged_decode, paged_prefill=paged_prefill,
                    paged_kv_write=paged_kv_write)
    paged_launches = paged_phase(torch, counters, card, model, load)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 9. slice 5: Llama-4-Scout (8 of 48 layers) MoE generation
    counters.update(gmm=gmm)
    moe_launches = moe_phase(torch, counters, card)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 10. slice 6: Mamba2-2.7B generation, then the hybrid unit (reduced Jamba)
    counters.update(ssd_scan=ssd_scan)
    ssm_launches = ssm_phase(torch, counters, card)
    gc.collect()
    torch.cuda.empty_cache()
    hybrid_phase(torch, counters, card)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 11. slice 5b: Llama-4-Scout (1 of 48 layers) MoE training
    counters.update(gmm_dw=gmm_dw)
    moe_train_launches = moe_train_phase(torch, counters, card)

    # launches: each kernel's count in the run of its path — the training
    # run for rows 1-5 (the embed and generation runs' counts of the
    # attention forward were checked in phases 4 and 7), the dense
    # generation run for rows 6-8, the paged one for rows 9-11, the MoE one
    # for row 12, the MoE training one for row 13, the Mamba2 one for row 14
    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
         "replaces": "src/repro/kernels/flash_attention.py:211",
         "launches": 0, "max_abs_err": fa_serving_err,
         "ms": fa_ms, "device_ms": fa_dev_ms, "plain_ms": fa_plain_ms, "bound_ms": fa_bound_ms,
         "bound_by": fa_bound_by, "library_ms": fa_lib_ms},
        fa_bwd_rec,
        *ce_recs,
        {"name": "layernorm", "route": "triton",
         "source": "src/repro_torch/kernels/rmsnorm.py",
         "replaces": "src/repro/kernels/rmsnorm.py:83",
         "launches": 0, "max_abs_err": ln_serving_err,
         "ms": ln_ms, "device_ms": ln_dev_ms, "plain_ms": ln_plain_ms, "bound_ms": ln_bound_ms,
         "bound_by": ln_bound_by, "library_ms": ln_lib_ms},
    ]
    for rec in kernels:
        rec["launches"] = train_launches[rec["name"]]
    for rec in gen_recs:
        rec["launches"] = gen_launches[rec["name"]]
    for rec in paged_recs:
        rec["launches"] = paged_launches[rec["name"]]
    gmm_rec["launches"] = moe_launches["gmm"]
    gmm_dw_rec["launches"] = moe_train_launches["gmm_dw"]
    ssd_rec["launches"] = ssm_launches["ssd_scan"]
    kernels += gen_recs + paged_recs + [gmm_rec, gmm_dw_rec, ssd_rec]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
