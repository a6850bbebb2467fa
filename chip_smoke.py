#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's kernels from the sources in this checkout and holds each
of the fourteen kernels, and the SSD scan's backward (the port's own),
against its plain PyTorch version on the card.  Then drives the eight
paths ported so far: embedding serving through
``LLM.embed`` and MLM pre-training through ``Trainer.run`` (about 10
optimizer steps, each unit of the stack under remat's default ``block``)
at the full width and depth of ESM-2 650M, with one micro-batch's loss and
gradients under remat ``none``, ``block`` and ``dots`` (the same bits);
generation through ``LLM.generate`` at the full width and depth of
Qwen2-7B (bf16 parameters, 32 slots, 64 prompts of 32 new tokens) over a
dense 2048-token cache, then over the paged cache through the serving
launcher's ``serve_continuous`` (prefix caching, 512-token chunked
prefill, 64 requests, the even ones behind one shared 512-token
preamble); and MoE generation through ``LLM.generate`` with
Llama-4-Scout at full width, its depth cut to 8 of 48 layers, on the same
load over the dense cache; and SSM generation through ``LLM.generate``
at the full width and depth of Mamba2-2.7B on the same load (ids within
its vocab), then the hybrid unit of Jamba-1.5-Large at ``reduced()`` size;
and MoE training through ``Trainer.run`` with Llama-4-Scout at full width,
1 of 48 layers (fp32 master weights, bf16 AdamW moments, 6 steps of 2 x
1024 packed protein tokens); LoRA fine-tuning of the ESM-2 650M just
trained (rank 8 on wq/wv, 10 steps); ESM-2 650M training through the data
plane (a sharded store, size-aware batches behind a background producer,
10 ``Trainer.run`` steps beside the ``ClusterSampler`` run), a bit-exact
resume through it (2 of 33 layers) and the training launcher
``launch.train.main`` with a profiler trace; ESM-2 650M trained 3 steps by
the sharded ``Trainer`` on a (1, 1) mesh in a world of one process over
NCCL, bit for bit the mesh-free run, and by ``launch.train`` under
``torchrun --mesh 1x1``; Qwen2-7B served by the engine on a (1, 1) mesh
over NCCL (16 prompts, dense and paged with prefix caching and 512-token
chunks) and ESM-2 650M's embeddings there, bit for bit the mesh-free
engine's, ``launch.serve`` under ``torchrun --mesh 1x1``, and two head-TP
ranks of Qwen2-7B (8 of 28 layers) on the one card over Gloo against the
mesh-free logits (the decode and prefill kernels' checks hold the ranks'
head counts too); and SSM training through
``Trainer.run`` at the full width and depth of Mamba2-2.7B (fp32 master
weights and AdamW moments, 6 steps of one 2 x 1024 micro-batch of packed
tokens under remat ``block``), reduced Jamba's hybrid unit and
``launch.train.main --arch mamba2-2.7b`` on size-aware batches; and the
rest of the zoo: Geneformer-106M embedding 96 rank-value-encoded cells
through ``LLM.embed`` and training 10 steps of 2 x 8 x 2048 through
``Trainer.run`` at full size, then Command-R-35B (8 of 40 layers, dense and
paged cache), Qwen1.5-32B (8 of 64) and Llama-3-405B (2 of 126) generating
through ``LLM.generate`` at full width; and the encoder-decoder and
frontend models: MolMIM-65M training 10 steps of 2 x 128 x 128 SMILES-sized
tokens through ``launch.train.make_batches`` and ``Trainer.run``, then
generating for 64 sources through ``launch.serve.generate``;
Whisper-medium serving 64 prompts through ``LLM.generate`` with one
audio of 1 500 frames for all (dense and paged cache), then 32 audios
through ``launch.serve.generate``; InternVL2-26B at full width, 24 of its
48 layers, serving 32 prompts behind one image of 256 rows (dense and paged), then
text-only; all with seeded random weights, checking what comes out of each.  Prints per-kernel times beside their bounds, the
embedding throughput, the training step time, tokens/s, MFU and peak
memory, the generation tokens/s, TTFT, decode-step time and idle share, the
router's drops, a profile of each path, then one JSON line of each step's
seconds (and the remat figures), one JSON line of kernel records and, last, ``{"ok": true, "device": {...}}``.  Exits non-zero,
printing no result, when there is no CUDA device or a phase fails.
Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
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


def time_ms(torch, fn, trials: int = 10, per_trial: int = 10, warmup: int = 3) -> float:
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


def device_ms_by_kernel(torch, fn, names, n: int = 10, floor: float = 0.0):
    """Device time of one call of ``fn`` for each of ``names``, from a
    torch.profiler window of ``n`` back-to-back calls.  Each kernel whose
    name holds one of ``names`` counts by its recorded instances: its
    summed time over its instance count (``e.count``), times the instances
    a call launches.  Every call launches each kernel the same number of
    times, so an instance count that is not a positive multiple of ``n``
    means the profiler dropped records in that window: it is taken again,
    up to three times.  Unlike ``time_ms`` it leaves out the host's launch
    path, which a small kernel can take longer than to run.  The dict is
    empty (not measured) when no window recorded every launch, or when the
    sum falls below ``floor`` (the work's bound: a reading the card cannot
    reach)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        out, whole = {}, True
        for e in prof.key_averages():
            hit = [m for m in names if m in e.key.lower()]
            if e.device_type != DeviceType.CUDA or not hit or e.self_device_time_total <= 0:
                continue
            per_call = e.count // n
            whole &= per_call > 0 and e.count == per_call * n
            out[hit[0]] = out.get(hit[0], 0.0) + e.self_device_time_total / 1e3 / e.count * per_call
        if out and whole:
            return out if sum(out.values()) >= floor else {}
    return {}


def device_ms(torch, fn, *names: str, n: int = 10, floor: float = 0.0):
    """The summed device time of one call of ``fn`` over the kernels named
    (``device_ms_by_kernel``), or None: not measured."""
    return sum(device_ms_by_kernel(torch, fn, names, n, floor).values()) or None


def busy_ms(torch, fn, n: int = 10):
    """Device time of one call of ``fn`` over every kernel it launches,
    from a profiler window of ``n`` back-to-back calls, or None: not
    measured (a library call whose kernels' names are not known)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return kernel_groups(prof, DeviceType)[0] / n or None


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def per_device_ms(amount: float, ms, unit: str, scale: float) -> str:
    """``amount`` over a device time as a rate, or "not measured"."""
    return f"{amount / ms / scale:.1f} {unit} on the device" if ms else "device rate not measured"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


class Clock:
    """The script's own time (it has 1 200 s in all): ``mark(name)`` prints
    the seconds so far and starts step ``name``; ``phases`` holds each
    finished step's seconds, in order."""

    def __init__(self):
        self.t0 = self.t = time.perf_counter()
        self.name = None
        self.phases = {}

    def mark(self, name=None) -> None:
        now = time.perf_counter()
        if self.name is not None:
            self.phases[self.name] = round(now - self.t, 1)
        self.name, self.t = name, now
        if name is not None:
            print(f"[chip_smoke +{now - self.t0:.1f} s] {name}", flush=True)

    def total(self) -> float:
        return time.perf_counter() - self.t0


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


def bf16_steps(torch, got, want, dims):
    """max |got − want| in bf16 steps of each row's max |want| (rows: the
    first ``dims`` axes)."""
    g = got.float().flatten(0, dims - 1).flatten(1)
    w = want.float().flatten(0, dims - 1).flatten(1)
    top = w.abs().amax(1, keepdim=True).clamp_min(1e-30)
    step = torch.exp2(torch.floor(torch.log2(top)) - 7)
    return ((g - w).abs() / step).max().item()


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
              "cross_entropy_bwd": 0.0, "layernorm": 0.0, "layernorm_bwd": 0.0, "rmsnorm": 0.0,
              "flash_decode": 0.0,
              "fused_sample": 0.0, "paged_decode": 0.0, "paged_prefill": 0.0,
              "paged_kv_write": 0.0, "gmm": 0.0, "gmm_dw": 0.0, "ssd_scan": 0.0, "ssd_scan_bwd": 0.0,
              "matmul": 0.0, "other": 0.0}
    for name, t, _ in kern:
        low = name.lower()
        paged = [g for g in ("paged_decode", "paged_prefill", "paged_kv_write") if g in low]
        if paged:
            groups[paged[0]] += t
        elif "flash_attention_fwd" in low:
            groups["flash_attention_fwd"] += t
        elif "flash_attention_bwd" in low:
            groups["flash_attention_bwd"] += t
        elif any(w in low for w in CE_FWD_KERNELS):
            groups["cross_entropy_fwd"] += t
        elif any(w in low for w in CE_BWD_KERNELS):
            groups["cross_entropy_bwd"] += t
        elif "layernorm_bwd" in low:
            groups["layernorm_bwd"] += t
        elif "layernorm" in low:
            groups["layernorm"] += t
        elif "rmsnorm" in low:
            groups["rmsnorm"] += t
        elif "flash_decode" in low:
            groups["flash_decode"] += t
        elif "gmm_dw_kernel" in low:
            groups["gmm_dw"] += t
        elif "gmm_fwd" in low or "gmm_dx_kernel" in low:   # the forward and its dx
            groups["gmm"] += t
        elif "ssd_scan_kernel" in low:
            groups["ssd_scan"] += t
        elif "ssd_bwd" in low:
            groups["ssd_scan_bwd"] += t
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


def visible_pairs(S, T, causal=False, window=0, q_offset=0) -> int:
    """(query, key) pairs of one head that the mask lets through: the work
    of QK^T and PV counted as the run's data needs it."""
    n = 0
    for i in range(S):
        qpos = i + q_offset
        hi = min(T - 1, qpos) if causal else T - 1
        lo = max(0, qpos - window + 1) if window > 0 else 0
        n += max(0, hi - lo + 1)
    return n


def attention_work(B, S, T, H, Hkv, D, kw, products):
    """(FLOP, bytes) of an attention call: ``products`` matrix products of 2
    FLOP a visible (query, key, d) triple (2 forward, 5 backward); bytes:
    the (B, S, H, D) and (B, T, Hkv, D) operands (q and out, or q, out, dO
    and dq; k and v, or k, v, dk, dv) read or written once, plus lse."""
    pairs = visible_pairs(S, T, kw.get("causal", False), kw.get("window", 0), kw.get("q_offset", 0))
    per_side = 2 if products == 2 else 4
    nbytes = per_side * (B * S * H * D + B * T * Hkv * D) * 2 + B * H * S * 4
    return 2 * products * B * H * D * pairs, nbytes


def sdpa_args(q, k, v, kw):
    """SDPA's (B, heads, L, D) operands and flags for the same attention: a
    causal window at least T long is plain causal masking."""
    assert kw.get("window", 0) == 0 or kw["window"] >= k.shape[1], "no SDPA mask for this window"
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    return qt, kt, vt, dict(is_causal=kw.get("causal", False), enable_gqa=k.shape[2] != q.shape[2])


# the shapes the paths launch the attention kernels at, timed in
# check_attention_fwd (all) and check_attention_bwd (the training ones)
ATTN_SHAPES = {
    "esm2-650m serving": (dict(B=32, S=1024, T=1024, H=20, Hkv=20, D=64), dict(causal=False)),
    "esm2-650m training": (dict(B=8, S=1024, T=1024, H=20, Hkv=20, D=64), dict(causal=False)),
    "qwen2-7b prefill, largest bucket": (dict(B=1, S=1024, T=1024, H=28, Hkv=4, D=128),
                                         dict(causal=True)),
    "llama4-scout training": (dict(B=2, S=1024, T=1024, H=40, Hkv=8, D=128),
                              dict(causal=True, window=8192)),
    "geneformer-106m training": (dict(B=8, S=2048, T=2048, H=12, Hkv=12, D=64),
                                 dict(causal=False)),
    "llama3-405b prefill, largest bucket": (dict(B=1, S=1024, T=1024, H=128, Hkv=8, D=128),
                                            dict(causal=True)),
    # slice 7: MolMIM's micro-batch (its cross-attention has the encoder's
    # shape: src_tokens mirror tokens), Whisper's encoder over one audio
    # and over 32, its cross-attention at the largest prompt bucket over
    # the 1 500 frames, InternVL2's prefill of 256 image rows and 1 024 text
    "molmim-65m training, encoder and cross": (dict(B=128, S=128, T=128, H=8, Hkv=8, D=64),
                                               dict(causal=False)),
    "molmim-65m training, decoder": (dict(B=128, S=128, T=128, H=8, Hkv=8, D=64),
                                     dict(causal=True)),
    "whisper-medium encoder": (dict(B=1, S=1500, T=1500, H=16, Hkv=16, D=64), dict(causal=False)),
    "whisper-medium cross, largest bucket": (dict(B=1, S=64, T=1500, H=16, Hkv=16, D=64),
                                             dict(causal=False)),
    "whisper-medium encoder, 32 audios": (dict(B=32, S=1500, T=1500, H=16, Hkv=16, D=64),
                                          dict(causal=False)),
    "internvl2-26b prefill, image and largest bucket": (
        dict(B=1, S=1280, T=1280, H=48, Hkv=8, D=128), dict(causal=True)),
}

# cross-attention's query and key lengths differ: T a multiple of 128 and
# not (Whisper's 1 500 frames leave a tail of 92 keys)
CROSS_CASES = [
    ("cross S != T, T 1500", dict(B=2, S=64, T=1500, H=16, Hkv=16, D=64), dict(causal=False)),
    ("cross S != T, T 300", dict(B=4, S=100, T=300, H=8, Hkv=8, D=64), dict(causal=False)),
]


# the CUDA kernels that one call of each attention wrapper runs
ATTN_KERNELS = {"flash_attention_fwd": ("flash_attention_fwd_kernel",),
                "flash_attention_bwd": ("flash_attention_bwd_delta_kernel",
                                        "flash_attention_bwd_dq_kernel",
                                        "flash_attention_bwd_dkv_kernel")}


def time_attention(torch, name, fn, plain, lib, flops, nbytes, card, label):
    """One timed shape of an attention kernel: its record's numbers."""
    ms = time_ms(torch, fn)
    bound_ms, bound_by = bound(flops, nbytes)
    parts = device_ms_by_kernel(torch, fn, ATTN_KERNELS[name], floor=bound_ms)
    dev_ms = sum(parts.values()) or None
    if len(ATTN_KERNELS[name]) > 1:
        print(f"{name} {label}: device ms by kernel " + ", ".join(
            f"{k} {fmt_ms(parts.get(k))}" for k in ATTN_KERNELS[name]))
    plain_ms = time_ms(torch, plain, trials=5, per_trial=2)
    lib_ms = time_ms(torch, lib)
    vs_lib = f"{dev_ms / lib_ms:.2f}" if dev_ms else "not measured"
    print(f"{name} {label} bf16 on {card}: {ms:.4f} ms (device {fmt_ms(dev_ms)} ms, "
          f"{per_device_ms(flops, dev_ms, 'TFLOP/s', 1e9)}; bound {bound_ms:.4f} ms by {bound_by}), "
          f"plain {plain_ms:.4f} ms, scaled_dot_product_attention"
          f"{' backward' if 'bwd' in name else ''} {lib_ms:.4f} ms (device / library {vs_lib})")
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms}


def check_attention_fwd(torch, F, ref, flash_attention_fwd, randn, card):
    """Row 1 against ``attention_ref`` in bf16 and fp16, then timed at every
    shape a path launches it at.  Returns its kernel record: the serving
    shape's numbers, each shape's under "shapes" (launches filled in
    later)."""
    # tolerances, for unit-normal inputs: the kernel rounds P to the input
    # dtype before PV (<= 2^-9 relative per probability in bf16) and both
    # round the output once; lse is fp32 from the same fp32 scores
    fa_tol = {torch.bfloat16: 3e-2, torch.float16: 4e-3}
    lse_tol = 1e-4
    cases = [(name, *ATTN_SHAPES[name]) for name in ATTN_SHAPES] + [
        ("qwen2-7b prefill, smallest bucket", dict(B=1, S=64, T=64, H=28, Hkv=4, D=128),
         dict(causal=True)),
        ("causal", dict(B=2, S=128, T=128, H=4, Hkv=4, D=64), dict(causal=True)),
        ("causal window", dict(B=2, S=200, T=200, H=4, Hkv=4, D=64), dict(causal=True, window=48)),
        ("softcap", dict(B=2, S=96, T=96, H=4, Hkv=4, D=64), dict(causal=False, softcap=20.0)),
        ("gqa H=8 Hkv=2", dict(B=2, S=128, T=128, H=8, Hkv=2, D=64), dict(causal=True)),
        ("D=128", dict(B=2, S=128, T=128, H=4, Hkv=4, D=128), dict(causal=False)),
        ("non-multiple S/T", dict(B=3, S=77, T=131, H=4, Hkv=4, D=64), dict(causal=False)),
    ] + CROSS_CASES + ATTN_EDGE_CASES
    serving_err = 0.0
    for label, s, kw in cases:
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
            dead = r_lse <= -1e29            # rows with no visible key: out 0, lse -1e30
            if bool(dead.any()):
                rows = out.transpose(1, 2).reshape(-1, s["S"], s["D"])[dead]
                check(bool((lse[dead] == -1e30).all()) and bool((rows == 0).all()),
                      f"flash_attention_fwd {label} {dt}: a row with no key is not 0, -1e30")
            if label == "esm2-650m serving" and dt == torch.bfloat16:
                serving_err = e_out
            del q, k, v, out, lse, r_out, r_lse

    shapes = {}
    for label, (s, kw) in ATTN_SHAPES.items():
        q = randn(s["B"], s["S"], s["H"], s["D"])
        k, v = randn(s["B"], s["T"], s["Hkv"], s["D"]), randn(s["B"], s["T"], s["Hkv"], s["D"])
        qt, kt, vt, flags = sdpa_args(q, k, v, kw)
        shapes[label] = time_attention(
            torch, "flash_attention_fwd", lambda: flash_attention_fwd(q, k, v, **kw),
            lambda: ref.attention_ref(q, k, v, **kw),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, **flags),
            *attention_work(**s, kw=kw, products=2), card, f"{label} {s} {kw}")
        del q, k, v, qt, kt, vt
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
            "replaces": "src/repro/kernels/flash_attention.py:211",
            "launches": 0, "max_abs_err": serving_err, **shapes["esm2-650m serving"],
            "shapes": shapes}


# cases both attention checks hold the kernels to: S and T not multiples
# of the 128-row tiles at D = 128, a causal window crossing tiles, a query
# offset, rows with no visible key, and a block with no key tile at all
ATTN_EDGE_CASES = [
    ("non-multiple S/T, D=128, gqa", dict(B=2, S=200, T=333, H=4, Hkv=2, D=128), dict(causal=False)),
    ("non-multiple S/T, D=128, causal window", dict(B=2, S=300, T=300, H=4, Hkv=2, D=128),
     dict(causal=True, window=100)),
    ("q_offset", dict(B=2, S=40, T=104, H=4, Hkv=2, D=128), dict(causal=True, q_offset=64)),
    # a rank of context parallelism over model=2: Qwen2-7B's heads, its
    # 512 query rows of a 1024-row sequence against all the keys
    ("qwen2-7b context-parallel rank 0", dict(B=1, S=512, T=1024, H=28, Hkv=4, D=128),
     dict(causal=True, q_offset=0)),
    ("qwen2-7b context-parallel rank 1", dict(B=1, S=512, T=1024, H=28, Hkv=4, D=128),
     dict(causal=True, q_offset=512)),
    ("fully-masked rows", dict(B=1, S=24, T=24, H=2, Hkv=2, D=64), dict(causal=True, q_offset=-8)),
    ("no visible key at all", dict(B=1, S=16, T=130, H=2, Hkv=1, D=128),
     dict(causal=True, q_offset=-200)),
]


# slice 7's LayerNorm shapes, with a bias: MolMIM's d 512 at a decode step
# of 64 rows and a micro-batch of 128 x 128, Whisper's d 1024 at a decode
# step of 32 slots and an encoder's 1 500 frames
SLICE7_LAYERNORM = [(64, 512, True), (16384, 512, True), (32, 1024, True), (1500, 1024, True)]


# the eight LayerNorm shapes the paths run, timed in check_layernorm:
# (rows, d, bias)
LAYERNORM_TIMED = [(32 * 1024, 1280, True), (32, 8192, False), (2048, 8192, False),
                   (16384, 768, True), *SLICE7_LAYERNORM]


def layernorm_tol(torch, dt):
    """(tolerance of |kernel - plain| elementwise, its label): 16-bit
    output: at most one output rounding step (2^-8 relative in bf16, 2^-11
    in fp16, at most twice that of |y|) beside the fp32 moments' noise;
    fp32: the moments summed in another order."""
    if dt == torch.bfloat16:
        return (lambda r: 1e-2 + 2**-7 * r.abs()), "1e-2 + 2^-7*|y|"
    if dt == torch.float16:
        return (lambda r: 1e-3 + 2**-10 * r.abs()), "1e-3 + 2^-10*|y|"
    return (lambda r: 1e-4), "1e-4"


def check_layernorm(torch, F, ref, layernorm, randn, card):
    """Row 5 against ``layernorm_ref`` in bf16, fp16 and fp32, with and
    without a bias, with w and b in x's dtype or another: at ESM-2's serving
    shape (32 768, 1280), ESM-2 3B's width 2560, Command-R's decode and
    prefill shapes without a bias ((32, 8192), (2048, 8192)), Geneformer's
    training shape (16 384, 768), slice 7's (``SLICE7_LAYERNORM``) and the
    widest row (16 384), and over a strided view of rows; at each case a
    repeat is bit-identical and a row alone equals its row in the batch bit
    for bit.  Times the eight shapes the paths run (``LAYERNORM_TIMED``)
    beside ``F.layer_norm`` (in turns: kernel, library, library, kernel),
    the plain version and the bound, and reads each shape's device time
    over inputs rotated past the 50 MB L2.  Returns its kernel record: the
    serving shape's numbers, the others under their shape (launches filled
    in later)."""
    import itertools

    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    # (rows, d, bias, x dtype, w dtype, b dtype)
    cases = [(rows, d, bias, dt, f32, f32) for rows, d, bias in (
        [(32 * 1024, 1280, bias) for bias in (True, False)]
        + [(32, 8192, False), (2048, 8192, False), (16384, 768, True), (8192, 2560, True),
           (32, 2560, True), (7, 16384, True)] + SLICE7_LAYERNORM) for dt in (bf16, f32)]
    cases += [(2048, 1024, True, f16, f16, f16), (32, 2560, True, f16, f16, f16),
              (16384, 512, True, bf16, bf16, f32), (1500, 1024, True, f32, bf16, f16),
              (2048, 8192, False, bf16, bf16, bf16), (64, 768, True, bf16, f16, bf16),
              (32, 1280, True, f16, f32, bf16)]
    serving_err = 0.0
    for rows, d, bias, dt, wdt, bdt in cases:
        x = randn(rows, d, dtype=dt, scale=3.0, shift=1.0)
        w = randn(d, dtype=wdt)
        b = randn(d, dtype=bdt) if bias else None
        y = layernorm(x, w, b)
        again = layernorm(x, w, b)
        torch.cuda.synchronize()
        r = ref.layernorm_ref(x, w, b)
        err = (y.float() - r.float()).abs()
        tol, label = layernorm_tol(torch, dt)
        ok = bool((err <= tol(r.float())).all()) and y.dtype == dt
        alone = all(torch.equal(layernorm(x[i:i + 1], w, b), y[i:i + 1])
                    for i in sorted({0, rows // 2, rows - 1}))
        print(f"layernorm ({rows}, {d}) x {str(dt)[6:]}, w {str(wdt)[6:]}, b "
              f"{str(bdt)[6:] if bias else None}: err {err.max().item():.3g} (tol {label}); a "
              f"repeat bit-identical {torch.equal(y, again)}, rows alone bit-equal {alone}")
        check(ok, f"layernorm ({rows}, {d}) {dt} w {wdt} bias={bias}")
        check(torch.equal(y, again), f"layernorm ({rows}, {d}) {dt}: a repeat differs")
        check(alone, f"layernorm ({rows}, {d}) {dt}: a row alone differs from its row in the batch")
        if dt == bf16 and bias and rows == 32 * 1024:
            serving_err = err.max().item()
        del x, y, again, r, err
    # rows of a strided view (every other row of a stacked pair, and a
    # column slice): the row stride is not d
    for dt in (bf16, f32):
        base = randn(4096, 2, 1280 + 64, dtype=dt, scale=3.0, shift=1.0)
        x = base[:, 1, 32:32 + 1280]
        w, b = randn(1280, dtype=f32), randn(1280, dtype=f32)
        y = layernorm(x, w, b)
        r = ref.layernorm_ref(x.contiguous(), w, b)
        tol, label = layernorm_tol(torch, dt)
        err = (y.float() - r.float()).abs()
        same = torch.equal(y, layernorm(x.contiguous(), w, b))
        print(f"layernorm strided rows (4096, 1280), row stride {x.stride(0)}, {str(dt)[6:]}: err "
              f"{err.max().item():.3g} (tol {label}); bit-equal to the contiguous copy's {same}")
        check(bool((err <= tol(r.float())).all()) and same, f"layernorm strided rows {dt}")
        del base, x, y, r, err

    rec = {"name": "layernorm", "route": "cuda", "source": "src/repro_torch/kernels/csrc/layernorm.cu",
           "replaces": "src/repro/kernels/rmsnorm.py:83", "launches": 0,
           "max_abs_err": serving_err}
    for rows, d, bias in LAYERNORM_TIMED:
        x = randn(rows, d)
        w = randn(d, dtype=torch.float32)
        b = randn(d, dtype=torch.float32) if bias else None
        wl = w.to(torch.bfloat16)
        bl = None if b is None else b.to(torch.bfloat16)
        nbytes = 2 * rows * d * 2 + (2 if bias else 1) * d * 4
        bound_ms, bound_by = bound(8 * rows * d, nbytes, PEAK_FP32_FLOPS)
        # the kernel and F.layer_norm in turns (kernel, library, library,
        # kernel): at the small shapes both are bound by the host's launch
        # path, and the host's speed drifts within a run
        turns = {"kernel": [], "library": []}
        for who in ("kernel", "library", "library", "kernel"):
            turns[who].append(time_ms(torch, (lambda: layernorm(x, w, b)) if who == "kernel"
                                      else (lambda: F.layer_norm(x, (d,), wl, bl, 1e-5))))
        ms, lib_ms = (statistics.mean(turns[who]) for who in ("kernel", "library"))
        dev_ms = device_ms(torch, lambda: layernorm(x, w, b), "layernorm", floor=bound_ms)
        lib_dev = busy_ms(torch, lambda: F.layer_norm(x, (d,), wl, bl, 1e-5))
        # the same shape over enough inputs that each call reads x from
        # DRAM, as a layer's norm does: its reading against the byte bound
        copies = -(-3 * 50 * 2**20 // (rows * d * 2))
        xs = itertools.cycle([randn(rows, d) for _ in range(copies)])
        dram_ms = device_ms(torch, lambda: layernorm(next(xs), w, b), "layernorm", floor=bound_ms)
        del xs
        reading = {"ms": ms, "device_ms": dev_ms, "device_ms_dram": dram_ms,
                   "plain_ms": time_ms(torch, lambda: ref.layernorm_ref(x, w, b)),
                   "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
                   "library_device_ms": lib_dev}
        print(f"layernorm ({rows}, {d}) bf16 bias={bias} on {card}: {ms:.4f} ms back to back, "
              f"device {fmt_ms(dev_ms)} ms, over {copies} inputs rotated past L2 {fmt_ms(dram_ms)} "
              f"ms (bound {bound_ms:.5f} ms by {bound_by}, "
              f"{per_device_ms(nbytes, dram_ms, 'GB/s', 1e6)}), plain {reading['plain_ms']:.4f} ms, "
              f"F.layer_norm {lib_ms:.4f} ms (device {fmt_ms(lib_dev)} ms)")
        if rows == 32 * 1024:
            rec.update(reading)
        else:
            rec[f"({rows}, {d}){'' if bias else ' no bias'}"] = reading
        del x
    return rec


# the training shapes of the LayerNorm backward: ESM-2 650M's micro-batch
# (8 x 1024 rows of 1280) and Geneformer's (8 x 2048 of 768) with bf16
# weights under the compute view, MolMIM's (128 x 128 of 512) with its fp32
# norm leaves; (rows, d, bias, w dtype name)
LAYERNORM_BWD_TIMED = [(8192, 1280, True, "bfloat16"), (16384, 768, True, "bfloat16"),
                       (16384, 512, True, "float32")]


def layernorm_bwd_grads_ok(torch, got, want, xdt):
    """(ok, worst error of dx, of dw and db, each over its tolerance): dx
    within one rounding step of x's dtype of each element (2^-7 of |dx| in
    bf16, 2^-10 in fp16, 1e-5 in fp32) plus 1e-4 of the row's max |dx|; dw
    and db, fp32 sums over the rows in another order rounded once to w's
    dtype, within that dtype's step (2^-7, 2^-10, 1e-5 of |g|) plus 2e-5
    of max |g|."""
    step = {torch.bfloat16: 2**-7, torch.float16: 2**-10, torch.float32: 1e-5}
    worst = []
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            continue
        gf, wf = g.float(), w.float()
        if i == 0:
            scale = wf.reshape(-1, wf.shape[-1]).abs().amax(1).reshape(wf.shape[:-1] + (1,))
            tol = 1e-4 * scale + step[xdt] * wf.abs()
        else:
            tol = 2e-5 * wf.abs().max() + step[w.dtype] * wf.abs()
        worst.append(((gf - wf).abs() / tol.clamp_min(1e-30)).max().item())
    return all(e <= 1 for e in worst), worst


def check_layernorm_bwd(torch, F, ref, layernorm_bwd, randn, card):
    """The port's own LayerNorm backward (``layernorm_bwd``, with row 5)
    against ``layernorm_bwd_ref`` and against the plain function that
    follows its schedule (``layernorm_bwd_sched_ref``), at the three
    training shapes (``LAYERNORM_BWD_TIMED``) with bf16 and fp32 weights
    and the schedule's edges: no bias, fp32 and fp16 x, a row count with a
    short last block, one row, ESM-2 3B's width 2560, the widest row
    (8192), a strided view of x's rows, an expanded dy and a dy that starts
    inside a 16-byte vector.  At each case a
    repeat is bit-identical and dx of a row alone equals its row in the
    batch.  Checks the schedule's grid against the kernel's.  Times
    the training shapes beside the plain version and ``F.layer_norm``'s
    backward (``torch.autograd.grad``).  Returns its record (ESM-2's shape;
    the others under their shape; launches filled in later)."""
    import ctypes

    from repro_torch.kernels import _build

    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    dts = {"float32": f32, "bfloat16": bf16}
    lib = _build.load("layernorm")
    # (rows, d, bias, x dtype, w and b dtype)
    cases = [(rows, d, bias, bf16, wdt) for rows, d, bias, _ in LAYERNORM_BWD_TIMED
             for wdt in (bf16, f32)]
    cases += [(8192, 1280, False, bf16, bf16), (16384, 768, True, f32, f32),
              (2048, 1024, True, f16, f16), (1000, 1280, True, bf16, bf16),
              (1, 512, True, bf16, f32), (4096, 2560, True, bf16, bf16),
              (512, 8192, False, bf16, bf16), (300, 96, True, f16, bf16)]
    first_err = None
    for rows, d, bias, dt, wdt in cases:
        x = randn(rows, d, dtype=dt, scale=3.0, shift=1.0)
        dy = randn(rows, d, dtype=dt)
        w = randn(d, dtype=wdt)
        b = randn(d, dtype=wdt) if bias else None
        got = layernorm_bwd(x, w, b, dy)
        again = layernorm_bwd(x, w, b, dy)
        torch.cuda.synchronize()
        want = ref.layernorm_bwd_ref(x, w, b, dy)
        sched = ref.layernorm_bwd_sched_ref(x, w, b, dy)
        ok, errs = layernorm_bwd_grads_ok(torch, got, want, dt)
        ok_s, errs_s = layernorm_bwd_grads_ok(torch, got, sched, dt)
        same = all(a is None or torch.equal(a, c) for a, c in zip(got, again))
        rows_alone = sorted({0, rows // 2, rows - 1})
        alone = all(torch.equal(layernorm_bwd(x[i:i + 1], w, b, dy[i:i + 1])[0], got[0][i:i + 1])
                    for i in rows_alone)
        r = ctypes.c_int()
        G = lib.layernorm_bwd_grid(rows, d, ctypes.byref(r))
        grid_ok = (G, r.value) == ref.layernorm_bwd_blocks(rows, d)
        print(f"layernorm_bwd ({rows}, {d}) x {str(dt)[6:]}, w {str(wdt)[6:]}, bias={bias}: "
              f"err / tol vs plain dx, dw, db {', '.join(f'{e:.3g}' for e in errs)}, vs the "
              f"schedule's {', '.join(f'{e:.3g}' for e in errs_s)} (<= 1); repeat bit-identical "
              f"{same}; dx of rows {rows_alone} alone bit-equal {alone}; {G} blocks of {r.value} "
              f"rows (the schedule's {ref.layernorm_bwd_blocks(rows, d)})")
        check(ok and ok_s and all(g.dtype == w_.dtype for g, w_ in zip(got, want) if w_ is not None),
              f"layernorm_bwd ({rows}, {d}) {dt} w {wdt} bias={bias}")
        check(same, f"layernorm_bwd ({rows}, {d}) {dt}: a repeat differs")
        check(alone, f"layernorm_bwd ({rows}, {d}) {dt}: dx of a row alone differs")
        check(grid_ok, f"layernorm_bwd ({rows}, {d}): the schedule's grid is not the kernel's")
        if first_err is None:
            first_err = max((g.float() - w_.float()).abs().max().item()
                            for g, w_ in zip(got, want) if w_ is not None)
        del x, dy, got, again, want, sched
    # rows of a strided view, and an expanded dy (the gradient of a sum)
    x = randn(2048, 2, 1280 + 64, dtype=bf16, scale=3.0, shift=1.0)[:, 1, 32:32 + 1280]
    w, b = randn(1280, dtype=bf16), randn(1280, dtype=bf16)
    for label, dy in (("strided x", randn(2048, 1280)),
                      ("expanded dy", randn(1, 1280).expand(2048, 1280)),
                      ("dy starting inside a vector", randn(2048 * 1280 + 1)[1:].view(2048, 1280))):
        got = layernorm_bwd(x, w, b, dy)
        want = layernorm_bwd(x.contiguous(), w, b, dy.contiguous())
        ok, errs = layernorm_bwd_grads_ok(torch, got, ref.layernorm_bwd_ref(x, w, b, dy), bf16)
        same = all(torch.equal(a, c) for a, c in zip(got, want))
        print(f"layernorm_bwd {label} (2048, 1280), x row stride {x.stride(0)}, dy strides "
              f"{dy.stride()}: err / tol {', '.join(f'{e:.3g}' for e in errs)}; bit-equal to the "
              f"contiguous copies' {same}")
        check(ok and same, f"layernorm_bwd {label}")

    rec = {"name": "layernorm_bwd", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/layernorm.cu",
           "replaces": None,     # the port's own: the reference's backward is XLA, not a kernel
           "reference": "src/repro/kernels/ops.py:518 (_ln_bwd, beside the Pallas forward)",
           "launches": 0, "max_abs_err": first_err}
    for rows, d, bias, wname in LAYERNORM_BWD_TIMED:
        wdt = dts[wname]
        x, dy = randn(rows, d, scale=3.0, shift=1.0), randn(rows, d)
        w, b = randn(d, dtype=wdt), randn(d, dtype=wdt)
        G = ref.layernorm_bwd_blocks(rows, d)[0]
        es = w.element_size()
        rows_bytes = 3 * rows * d * 2 + 4 * d * es
        part_bytes = 2 * (2 * G * d * 4)      # the partials, written and read back
        # the function's bytes: the kernel's partials are its design's
        # workspace, not work that the gradient needs (beside it, under
        # bound_ms_with_partials)
        bound_ms, bound_by = bound(16 * rows * d, rows_bytes, PEAK_FP32_FLOPS)
        bound_ws = bound(16 * rows * d, rows_bytes + part_bytes, PEAK_FP32_FLOPS)[0]
        xl = x.detach().requires_grad_(True)
        wl, bl = (t.to(bf16).requires_grad_(True) for t in (w, b))
        yl = F.layer_norm(xl, (d,), wl, bl, 1e-5)
        lib = lambda: torch.autograd.grad(yl, (xl, wl, bl), dy, retain_graph=True)  # noqa: E731
        turns = {"kernel": [], "library": []}
        for who in ("kernel", "library", "library", "kernel"):
            turns[who].append(time_ms(torch, (lambda: layernorm_bwd(x, w, b, dy)) if who == "kernel"
                                      else lib))
        ms, lib_ms = (statistics.mean(turns[who]) for who in ("kernel", "library"))
        parts = device_ms_by_kernel(torch, lambda: layernorm_bwd(x, w, b, dy),
                                    ("layernorm_bwd_kernel", "layernorm_bwd_sum_kernel"),
                                    floor=bound(0, rows_bytes)[0])
        dev_ms = sum(parts.values()) or None
        lib_dev = busy_ms(torch, lib)
        plain_ms = time_ms(torch, lambda: ref.layernorm_bwd_ref(x, w, b, dy), trials=5)
        print(f"layernorm_bwd ({rows}, {d}) bf16 x, {wname} w and b, on {card}: {ms:.4f} ms back "
              f"to back, device {fmt_ms(dev_ms)} ms (" + ", ".join(
                  f"{k} {v:.4f}" for k, v in parts.items()) + f"); bound {bound_ms:.5f} ms by "
              f"{bound_by} ({rows_bytes / 1e6:.1f} MB of rows and weights; {bound_ws:.5f} ms "
              f"with the kernel's {part_bytes / 1e6:.1f} MB of partials), "
              f"{per_device_ms(rows_bytes, dev_ms, 'GB/s', 1e6)}; plain "
              f"{plain_ms:.4f} ms, F.layer_norm backward {lib_ms:.4f} ms (device {fmt_ms(lib_dev)} "
              f"ms)")
        reading = {"ms": ms, "device_ms": dev_ms, "device_ms_by_kernel": parts,
                   "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                   "bound_ms_with_partials": bound_ws, "library_ms": lib_ms,
                   "library_device_ms": lib_dev}
        if rows == 8192:
            rec.update(reading)
        else:
            rec[f"({rows}, {d}) {wname} w"] = reading
        del x, dy, xl, wl, bl, yl
    return rec


def check_attention_bwd(torch, F, ref, flash_attention_fwd, flash_attention_bwd, randn, card):
    """Row 2 against ``attention_bwd_ref`` in bf16 and fp16, with
    bit-identical repeats, then timed at every shape a path launches it at.
    Returns its kernel record: the ESM-2 training shape's numbers, each
    shape's under "shapes" (launches filled in later)."""
    # tolerance relative to max|ref| per gradient: the kernel rounds P and
    # dS to the input dtype before the three products that take them (at
    # most 2^-9 relative per element in bf16, 2^-12 in fp16) where the
    # plain version keeps fp32; the gradients are rounded once in both
    tol = {torch.bfloat16: 2e-2, torch.float16: 4e-3}
    train = ("esm2-650m training", "llama4-scout training", "geneformer-106m training",
             "molmim-65m training, encoder and cross", "molmim-65m training, decoder")
    repeat = train + ("non-multiple S/T, D=128, gqa",) + tuple(c[0] for c in CROSS_CASES)
    cases = [(name, *ATTN_SHAPES[name]) for name in train] + [
        ("causal", dict(B=2, S=128, T=128, H=4, Hkv=4, D=64), dict(causal=True)),
        ("causal window", dict(B=2, S=200, T=200, H=4, Hkv=4, D=64), dict(causal=True, window=48)),
        ("softcap", dict(B=2, S=96, T=96, H=4, Hkv=4, D=64), dict(causal=False, softcap=20.0)),
        ("gqa H=8 Hkv=2", dict(B=2, S=128, T=128, H=8, Hkv=2, D=64), dict(causal=True)),
        ("D=128", dict(B=2, S=128, T=128, H=4, Hkv=4, D=128), dict(causal=False)),
        ("non-multiple S/T", dict(B=3, S=77, T=131, H=4, Hkv=4, D=64), dict(causal=False)),
    ] + CROSS_CASES + ATTN_EDGE_CASES
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
            if label.startswith("no visible"):
                check(all(bool((x == 0).all()) for x in got), "no visible key: a gradient is not 0")
            if label in repeat:
                again = flash_attention_bwd(q, k, v, out, lse, do, **kw)
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                print(f"flash_attention_bwd {label} {str(dt)[6:]}: a repeat is bit-identical: {same}")
                check(same, f"flash_attention_bwd {label} {dt}: a repeat differs")
            if label == "esm2-650m training" and dt == torch.bfloat16:
                first_err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
            del q, k, v, do, out, lse, got, want

    shapes = {}
    for label in train:
        s, kw = ATTN_SHAPES[label]
        q, do = randn(s["B"], s["S"], s["H"], s["D"]), randn(s["B"], s["S"], s["H"], s["D"])
        k, v = randn(s["B"], s["T"], s["Hkv"], s["D"]), randn(s["B"], s["T"], s["Hkv"], s["D"])
        out, lse = flash_attention_fwd(q, k, v, **kw)
        qt, kt, vt, flags = sdpa_args(q, k, v, kw)
        qt, kt, vt = (x.requires_grad_(True) for x in (qt, kt, vt))
        ot = F.scaled_dot_product_attention(qt, kt, vt, **flags)
        dot = do.transpose(1, 2).contiguous()
        shapes[label] = time_attention(
            torch, "flash_attention_bwd",
            lambda: flash_attention_bwd(q, k, v, out, lse, do, **kw),
            lambda: ref.attention_bwd_ref(q, k, v, out, lse, do, **kw),
            lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True),
            *attention_work(**s, kw=kw, products=5), card, f"{label} {s} {kw}")
        del q, k, v, do, out, lse, qt, kt, vt, ot, dot
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention.py:451",
            "launches": 0, "max_abs_err": first_err, **shapes["esm2-650m training"],
            "shapes": shapes}


CE_FWD_KERNELS = ("ce_fwd_kernel", "ce_fwd_merge_kernel")
CE_BWD_KERNELS = ("ce_bwd_dlogits_kernel", "ce_bwd_dh_kernel", "ce_bwd_dw_kernel",
                  "ce_bwd_dw_sum_kernel", "ce_bwd_zero_kernel")


def check_cross_entropy(torch, F, ref, cross_entropy_fwd, cross_entropy_bwd, randn, g, card):
    """Rows 3 and 4 against their plain versions, at ESM-2's, Llama-4-Scout's,
    Geneformer's and MolMIM's training shapes and at the edges of the
    kernels' schedule, with a bit-identical repeat; times the four training
    shapes.  Returns their kernel records: ESM-2's numbers, the others under
    "scout", "geneformer" and "molmim"."""
    dev = torch.device("cuda")
    # loss/lse: fp32 logits of the same products summed in another order;
    # dh/dw: the kernel rounds dlogits to bf16 before the two products
    # (2^-9 relative per element) where the plain version keeps fp32
    loss_tol, grad_tol = 2e-4, 2e-2
    cases = [
        ("esm2-650m tied head", dict(T=8192, D=1280, Vp=256, vocab=33, tied=True)),
        ("llama4-scout untied head", dict(T=2048, D=5120, Vp=202240, vocab=202048, tied=False)),
        ("geneformer-106m tied head", dict(T=16384, D=768, Vp=25600, vocab=25426, tied=True)),
        ("molmim-65m untied head", dict(T=128 * 127, D=512, Vp=768, vocab=523, tied=False)),
        ("T not a multiple of the 128-token tile, untied head",
         dict(T=1000, D=1280, Vp=256, vocab=33, tied=False)),
        ("Vpad 32768, 250 live tiles, tied head", dict(T=2048, D=1280, Vp=32768, vocab=32000, tied=True)),
        ("vocab ending mid-tile, targets in the last live tile",
         dict(T=300, D=256, Vp=1024, vocab=705, tied=False, last_tile=True)),
        ("vocab ending mid-tile, tied head", dict(T=300, D=256, Vp=1024, vocab=705, tied=True, last_tile=True)),
        ("out-of-range targets", dict(T=260, D=512, Vp=512, vocab=300, tied=False, out_of_range=True)),
    ]
    errs0 = {}
    for label, c in cases:
        T, D, Vp, vocab = c["T"], c["D"], c["Vp"], c["vocab"]
        h = randn(T, D)
        w = randn(Vp, D, scale=0.05).T if c["tied"] else randn(D, Vp, scale=0.05)
        tgt = torch.randint(0, vocab, (T,), device=dev, generator=g, dtype=torch.int32)
        if c.get("last_tile"):
            tgt[::3] = torch.randint(vocab // 128 * 128, vocab, (len(tgt[::3]),), device=dev,
                                     generator=g, dtype=torch.int32)
        bad = torch.zeros(T, dtype=torch.bool, device=dev)
        if c.get("out_of_range"):
            for i, t in enumerate((-1, vocab, vocab + 1, Vp - 1, Vp, Vp + 7, 1 << 30, -(1 << 30))):
                tgt[5 * i] = t
                bad[5 * i] = True
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
        layout = dw.shape == w.shape and dw.stride() == w.stride()
        sentinel = bool((loss[bad] > 1e29).all() and (loss[~bad] < 1e29).all())
        print(f"cross_entropy {label} (T={T}, D={D}, Vpad={Vp}, vocab={vocab}): loss/lse err "
              f"{e_loss:.3g} (tol {loss_tol}), dh {e_dh:.3g}, dw {e_dw:.3g} (tol {grad_tol} of "
              f"max|ref|), padded dw columns exactly 0: {pad_zero}, dw in w's layout: {layout}, "
              f"out-of-range targets give lse + 1e30: {sentinel} ({int(bad.sum())} of them)")
        check(e_loss <= loss_tol and bool(lse.isfinite().all()) and sentinel,
              f"cross_entropy_fwd {label}")
        check(e_dh <= grad_tol and e_dw <= grad_tol and pad_zero and layout,
              f"cross_entropy_bwd {label}")
        if not errs0:
            errs0 = {"fwd": e_loss, "bwd": max((dh.float() - r_dh.float()).abs().max().item(),
                                               (dw.float() - r_dw.float()).abs().max().item())}
        del r_dh, r_dw, r_loss, r_lse
        if label.split()[0] in ("esm2-650m", "llama4-scout", "geneformer-106m",
                                "molmim-65m"):  # training
            loss2, lse2 = cross_entropy_fwd(h, w, tgt, vocab=vocab)
            dh2, dw2 = cross_entropy_bwd(h, w, tgt, lse2, gl, gs, vocab=vocab)
            same = all(torch.equal(a, b) for a, b in ((loss, loss2), (lse, lse2), (dh, dh2), (dw, dw2)))
            print(f"cross_entropy {label}: a repeated forward and backward give the same bits: {same}")
            check(same, f"cross_entropy {label}: a repeat differs")
            del loss2, lse2, dh2, dw2
        del h, w, dh, dw
        torch.cuda.empty_cache()

    def timed(T, D, Vp, vocab, tied, reps):
        """Times at one shape: back to back, on the device, the plain
        version's and ``F.cross_entropy(h @ W)``'s forward and backward."""
        h = randn(T, D)
        w = randn(Vp, D, scale=0.05).T if tied else randn(D, Vp, scale=0.05)
        tgt = torch.randint(0, vocab, (T,), device=dev, generator=g, dtype=torch.int32)
        gl = torch.full((T,), 1.0 / T, device=dev)
        gs = torch.zeros(T, device=dev)
        loss, lse = cross_entropy_fwd(h, w, tgt, vocab=vocab)
        fwd = lambda: cross_entropy_fwd(h, w, tgt, vocab=vocab)            # noqa: E731
        bwd = lambda: cross_entropy_bwd(h, w, tgt, lse, gl, gs, vocab=vocab)  # noqa: E731
        trials, per, warm = reps
        out = {"fwd_ms": time_ms(torch, fwd, trials, per, warm),
               "bwd_ms": time_ms(torch, bwd, trials, per, warm)}
        out["fwd_plain"] = time_ms(torch, lambda: ref.cross_entropy_ref(h, w, tgt, vocab),
                                   trials=min(trials, 5), per_trial=min(per, 5), warmup=1)
        out["bwd_plain"] = time_ms(torch, lambda: ref.cross_entropy_bwd_ref(h, w, tgt, lse, gl, gs, vocab),
                                   trials=min(trials, 5), per_trial=min(per, 5), warmup=1)
        hl = h.clone().requires_grad_(True)
        wl = w[:, :vocab].clone().requires_grad_(True)
        tl = tgt.long()
        out["fwd_lib"] = time_ms(torch, lambda: F.cross_entropy((hl @ wl).float(), tl, reduction="none"),
                                 trials, per, warm)
        lib_loss = F.cross_entropy((hl @ wl).float(), tl, reduction="none")
        out["bwd_lib"] = time_ms(torch, lambda: torch.autograd.grad(lib_loss, (hl, wl), gl, retain_graph=True),
                                 trials, per, warm)
        # only the work the function needs: the `vocab` live columns of W
        # (the padded ones give no output but dW's zeros).  Forward: h and
        # W's live columns read, targets read, loss and lse written.
        # Backward: the same reads plus lse and the two cotangents, dh
        # written and dW written whole
        reads = T * D * 2 + D * vocab * 2 + T * 4
        out["fwd_bound"], out["fwd_bound_by"] = bound(2 * T * D * vocab, reads + 2 * T * 4)
        out["bwd_bound"], out["bwd_bound_by"] = bound(6 * T * D * vocab,
                                                      reads + 3 * T * 4 + T * D * 2 + D * Vp * 2)
        n = max(3, per)
        out["fwd_by"] = device_ms_by_kernel(torch, fwd, CE_FWD_KERNELS, n, out["fwd_bound"])
        out["bwd_by"] = device_ms_by_kernel(torch, bwd, CE_BWD_KERNELS, n, out["bwd_bound"])
        out["fwd_dev"] = sum(out["fwd_by"].values()) or None
        out["bwd_dev"] = sum(out["bwd_by"].values()) or None
        for d in ("fwd", "bwd"):
            flops = (2 if d == "fwd" else 6) * T * D * vocab
            by = ", ".join(f"{k} {v:.4f}" for k, v in out[f"{d}_by"].items())
            print(f"cross_entropy_{d} T={T} D={D} Vpad={Vp} vocab={vocab} bf16 on {card}: "
                  f"{out[f'{d}_ms']:.4f} ms (device {fmt_ms(out[f'{d}_dev'])} ms: {by}; bound "
                  f"{out[f'{d}_bound']:.4f} ms by {out[f'{d}_bound_by']}, "
                  f"{per_device_ms(flops, out[f'{d}_dev'], 'TFLOP/s', 1e9)}), plain "
                  f"{out[f'{d}_plain']:.4f} ms, F.cross_entropy(h @ W){' backward' if d == 'bwd' else ''} "
                  f"{out[f'{d}_lib']:.4f} ms")
        del h, w, hl, wl, lib_loss
        torch.cuda.empty_cache()
        return out

    esm = timed(8192, 1280, 256, 33, True, (20, 10, 3))
    scout = timed(2048, 5120, 202240, 202048, False, (3, 2, 1))
    gene = timed(16384, 768, 25600, 25426, True, (5, 5, 2))
    molmim = timed(128 * 127, 512, 768, 523, False, (10, 10, 2))
    rec = {"route": "cuda", "source": "src/repro_torch/kernels/csrc/cross_entropy.cu", "launches": 0}

    def fields(t, d):
        return dict(ms=t[f"{d}_ms"], device_ms=t[f"{d}_dev"], plain_ms=t[f"{d}_plain"],
                    bound_ms=t[f"{d}_bound"], bound_by=t[f"{d}_bound_by"], library_ms=t[f"{d}_lib"],
                    device_ms_by_kernel=t[f"{d}_by"])

    return [
        dict(rec, name="cross_entropy_fwd", replaces="src/repro/kernels/cross_entropy.py:120",
             max_abs_err=errs0["fwd"], **fields(esm, "fwd"), scout=fields(scout, "fwd"),
             geneformer=fields(gene, "fwd"), molmim=fields(molmim, "fwd")),
        dict(rec, name="cross_entropy_bwd", replaces="src/repro/kernels/cross_entropy.py:266",
             max_abs_err=errs0["bwd"], **fields(esm, "bwd"), scout=fields(scout, "bwd"),
             geneformer=fields(gene, "bwd"), molmim=fields(molmim, "bwd")),
    ]


def fwd_runs(policy: str) -> int:
    """How often one training micro-batch runs each forward kernel inside
    the stack under remat ``policy``: twice under ``block`` and ``dots``
    (the backward runs each unit again; the kernels are not the 2-D
    matmuls that ``dots`` keeps), once under ``none`` and ``full``."""
    return 2 if policy in ("block", "dots") else 1


def step_launches(num_layers: int, policy: str):
    """The launches of one ESM-2 micro-batch's forward and backward under
    remat ``policy``: one attention forward and backward a layer, two
    LayerNorms a layer and the final one, each with its backward, one
    cross-entropy forward and backward; each forward inside the stack
    ``fwd_runs(policy)`` times."""
    r = fwd_runs(policy)
    return {"flash_attention_fwd": r * num_layers, "flash_attention_bwd": num_layers,
            "layernorm": r * 2 * num_layers + 1, "layernorm_bwd": 2 * num_layers + 1,
            "cross_entropy_fwd": 1, "cross_entropy_bwd": 1}


def step_cost(torch, fn):
    """(wall ms, device busy ms or None, peak GB) of one call of ``fn``
    after a warm-up call: the wall with a sync, the peak memory allocated
    in that call, the busy time from one more call under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy_ms = kernel_groups(prof, DeviceType)[0]
    return wall_ms, busy_ms or None, peak_gb


def train_phase(torch, model, counters, card):
    """The slice: ESM-2 650M MLM pre-training through ``Trainer.run`` at full
    width and depth; returns the launch counts of its run and the cost of
    one optimizer step at accum 1 (8 x 1024), ``step_cost``'s triple."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.config import TrainConfig
    from repro_torch.core.module import tree_leaves
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
    policy = model.pc.remat_policy
    want = {k: v * steps * accum for k, v in step_launches(cfg.num_layers, policy).items()}
    print(f"main path: Trainer.run of {steps} steps x {accum} micro-batches, remat {policy}: "
          f"launches {launches} (want {want})")
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
    gc.collect()
    torch.cuda.empty_cache()

    # one optimizer step at accum 1 on the trainer's own state: the figure
    # the LoRA step is held beside
    full = step_cost(torch, lambda: one(state, mb))
    print(f"one pre-training step at accum 1 (8x1024, clip + AdamW over every weight) on {card}: "
          f"wall {full[0]:.1f} ms, device busy {fmt_ms(full[1])} ms, peak memory {full[2]:.2f} GB")

    # remat: one 8 x 1024 micro-batch's loss and gradients at none, block
    # and dots on the trained weights -- the same bits, each policy's
    # launches, peak memory and device time
    remat = remat_policies(torch, cfg, params, mb, counters, card, expect)

    # the kernel path against the plain path: loss and every grad leaf at
    # full width and depth on a 2 x 512 batch
    small = {k: v[:2, :512].contiguous() for k, v in mb.items()}
    plain_model = Model(dataclasses.replace(cfg, kernel_impl="torch"), params)

    k_loss, k_grads = loss_grads(torch, model, small)
    p_loss, p_grads = loss_grads(torch, plain_model, small)
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
    return launches, full, remat


def remat_policies(torch, cfg, params, batch, counters, card, expect):
    """One micro-batch's ``loss_fn`` and backward on ``params`` under each
    of remat's ``none``, ``block`` and ``dots``: the loss and the digest of
    every gradient leaf must be equal across them, and each run's launches
    ``step_launches`` of its policy.  Prints each policy's peak memory
    (above what was allocated before) and device time from ``step_cost``.
    Returns {policy: (digest, wall ms, device ms, peak GB, peak above the
    start GB)}."""
    from repro_torch.core.config import ParallelConfig
    from repro_torch.models.model import Model

    out = {}
    for policy in ("none", "block", "dots"):
        m = Model(cfg, params, ParallelConfig(remat_policy=policy))
        for fn in counters.values():
            fn.launches = 0
        loss, grads = loss_grads(torch, m, batch)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in counters.items()}
        want = step_launches(cfg.num_layers, policy)
        digest = tree_digest(torch, {f"{i:04d}": g for i, g in enumerate(grads)})
        del grads
        gc.collect()
        torch.cuda.empty_cache()
        base_gb = torch.cuda.memory_allocated() / 1e9
        wall, busy, peak = step_cost(torch, lambda: loss_grads(torch, m, batch))
        out[policy] = (loss, digest, wall, busy, peak, peak - base_gb)
        shape = "x".join(map(str, batch["tokens"].shape))
        print(f"remat {policy}: ESM-2 650M loss_fn + backward ({shape}) on {card}: loss {loss!r}, gradient digest {digest}; launches {launches} (want "
              f"{want}); wall {wall:.1f} ms, device busy {fmt_ms(busy)} ms, peak memory "
              f"{peak:.2f} GB ({peak - base_gb:.2f} GB above the {base_gb:.2f} GB before it)")
        expect(launches == want, f"remat {policy} launch counts")
        del m
    same = len({(v[0], v[1]) for v in out.values()}) == 1
    print(f"remat none, block and dots: loss and gradients bit-identical {same}")
    expect(same, "the remat policies' losses or gradients differ")
    return out


def tree_digest(torch, tree, chunk: int = 1 << 24) -> str:
    """A digest of every leaf's bytes, taken on the device a chunk at a
    time: per leaf the sum of its bytes and the sum of its bytes weighted by
    their position (mod 65521), hashed on the host."""
    import hashlib

    from repro_torch.core.module import tree_leaves

    sums = []
    for t in tree_leaves(tree):
        b = t.detach().contiguous().view(torch.uint8).reshape(-1)
        acc = torch.zeros(2, dtype=torch.int64, device=b.device)
        for i in range(0, b.numel(), chunk):
            x = b[i:i + chunk].long()
            pos = torch.arange(i, i + x.numel(), device=b.device) % 65521 + 1
            acc += torch.stack([x.sum(), (x * pos).sum()])
        sums.append(acc)
    return hashlib.sha256(torch.stack(sums).cpu().numpy().tobytes()).hexdigest()[:16]


def lora_phase(torch, model, counters, card, full):
    """LoRA fine-tuning of the ESM-2 650M the train phase trained, at full
    width and depth: rank-8 adapters (alpha 16) on every layer's wq and wv
    over the frozen fp32 master params, 10 steps of the reference example's
    step (the gradient over the adapter tree, then AdamW at lr 2e-3 without
    decay) on 8 x 1024 MLM batches of a shifted corpus (seed 123).  Gates:
    the zero-init identity bit for bit, a falling loss, the base
    bit-unchanged, alpha trained, the launch counts, a bit-identical
    repeated step and the adapter gradients against the plain route.
    ``full`` is the train phase's accum-1 step cost, printed beside the
    LoRA step's.  Returns the launch counts of the 10 steps."""
    import numpy as np

    from repro_torch.core.config import TrainConfig
    from repro_torch.core.module import tree_leaves, tree_map
    from repro_torch.data.dataset import build_synthetic_protein_memmap
    from repro_torch.data.pipeline import MLMBatches
    from repro_torch.data.sampler import ClusterSampler, greedy_length_clusters
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.training import lora

    cfg, dev = model.cfg, model.device
    steps, micro, seq, rank = 10, 8, 1024, 8
    failed = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    base = model.params.tree()
    digest = tree_digest(torch, base)
    adapters = lora.init_adapters(base, rank=rank, alpha=16.0,
                                  generator=torch.Generator(dev).manual_seed(0))
    n_lora = lora.count_trainable(adapters)
    n_base = sum(p.numel() for p in tree_leaves(base))
    tmp = tempfile.TemporaryDirectory()
    ds, tok = build_synthetic_protein_memmap(f"{tmp.name}/shifted", n=1024, seed=123, min_len=100,
                                             max_len=1023)
    pipe = iter(MLMBatches(ds, tok, ClusterSampler(greedy_length_clusters(ds.lengths(), 64), seed=1),
                           micro, seq, mask_prob=cfg.mlm_mask_prob, seed=1))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in next(pipe).items()} for _ in range(steps)]
    loss_fn = lora.make_lora_loss(model, base)
    tc = TrainConfig(learning_rate=2e-3, weight_decay=0.0)
    lr = torch.tensor(2e-3, device=dev)

    def step(ad, opt, batch):
        leaves = tree_leaves(ad)
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = loss_fn(ad, batch)
        grads = list(torch.autograd.grad(loss, leaves))
        return adamw.apply_updates(ad, grads, opt, lr, tc), loss.detach()

    def clone(ad, opt):
        c = lambda t: t.detach().clone()  # noqa: E731
        return tree_map(c, ad), adamw.AdamWState(step=opt.step.clone(), mu=tree_map(c, opt.mu),
                                                 nu=tree_map(c, opt.nu))

    with torch.no_grad():
        base_loss = model.loss_fn(base, batches[0])[0].item()
    print(f"LoRA data: {len(ds)} synthetic sequences of 100-1022 residues from motif library "
          f"seed 123; rank {rank}, alpha 16 on {len(adapters['weights'])} stacked weights "
          f"({', '.join(sorted(adapters['weights']))}): {n_lora:,} trainable values of "
          f"{n_base:,} ({n_lora / n_base:.4%}); AdamW lr 2e-3, no decay, {steps} steps of "
          f"{micro}x{seq}")

    opt = adamw.init_state(adapters)
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for b in batches:
        opt, loss = step(adapters, opt, b)
        losses.append(loss)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    want = {k: v * steps for k, v in step_launches(cfg.num_layers,
                                                   model.pc.remat_policy).items()}
    # the first layer's first LayerNorm takes no gradient: its input (the
    # frozen embedding) and its weights need none
    want["layernorm_bwd"] -= steps
    losses = torch.stack(losses).tolist()
    print(f"main path: {steps} LoRA steps: launches {launches} (want {want}); "
          f"{wall_s / steps * 1e3:.1f} ms a step (wall, host included)")
    print("LoRA losses: " + ", ".join(f"{x:.4f}" for x in losses))
    expect(launches == want, "LoRA launch counts")
    expect(all(np.isfinite(losses)), "non-finite LoRA loss")
    expect(losses[0] == base_loss, f"step-0 LoRA loss {losses[0]!r} is not the base's "
                                   f"{base_loss!r} bit for bit")
    with torch.no_grad():
        adapted = loss_fn(adapters, batches[0])[0].item()
    print(f"zero-init identity: step-0 loss {losses[0]!r} vs loss_fn(base) {base_loss!r}; the "
          f"first batch's loss: base {base_loss:.4f} -> adapted {adapted:.4f}")
    expect(adapted < base_loss, "the LoRA loss did not fall")
    alpha = adapters["alpha"].item()
    after = tree_digest(torch, base)
    print(f"alpha 16.0 -> {alpha!r} (trained, as in the reference); base digest {digest} -> {after}")
    expect(alpha != 16.0, "alpha did not move")
    expect(after == digest, "the base params changed")

    # one step repeated from the same adapters, moments and batch
    a1, o1 = clone(adapters, opt)
    a2, o2 = clone(adapters, opt)
    o1, _ = step(a1, o1, batches[0])
    o2, _ = step(a2, o2, batches[0])
    torch.cuda.synchronize()
    x = tree_leaves(a1) + tree_leaves(o1.mu) + tree_leaves(o1.nu)
    y = tree_leaves(a2) + tree_leaves(o2.mu) + tree_leaves(o2.nu)
    differ = sum(not torch.equal(p, q) for p, q in zip(x, y))
    print(f"one LoRA step repeated: {differ} of {len(x)} adapter and moment leaves differ")
    expect(differ == 0, "a repeated LoRA step is not bit-identical")
    del a1, a2, o1, o2, x, y
    gc.collect()
    torch.cuda.empty_cache()

    spare = clone(adapters, opt)
    cost = step_cost(torch, lambda: step(*spare, batches[1]))
    del spare
    print(f"LoRA step vs full pre-training step on {card} (8x1024, accum 1, same run): wall "
          f"{cost[0]:.1f} vs {full[0]:.1f} ms, device busy {fmt_ms(cost[1])} vs {fmt_ms(full[1])} ms, "
          f"peak memory {cost[2]:.2f} vs {full[2]:.2f} GB; trainable share {n_lora / n_base:.4%}")

    # the kernel route against the plain route: loss and every adapter
    # gradient on a 2 x 512 batch, at the trained adapters
    small = {k: v[:2, :512].contiguous() for k, v in batches[0].items()}
    plain = Model(dataclasses.replace(cfg, kernel_impl="torch"), base)

    def loss_grads(m):
        leaves = tree_leaves(adapters)
        loss, _ = lora.make_lora_loss(m, base)(adapters, small)
        return loss.item(), torch.autograd.grad(loss, leaves)

    k_loss, k_grads = loss_grads(model)
    p_loss, p_grads = loss_grads(plain)
    cos = [cosine(torch, a, b) for a, b in zip(k_grads, p_grads)]
    names = leaf_paths(adapters)
    worst = min(range(len(cos)), key=lambda i: cos[i])
    print(f"LoRA kernel route vs plain route (2x512): loss {k_loss:.6f} vs {p_loss:.6f} (|diff| "
          f"{abs(k_loss - p_loss):.3g}, tol 2e-2); adapter grad cosine min {cos[worst]:.6f} "
          f"({names[worst]}, of {len(cos)} leaves with alpha's; floor 0.999), alpha's grad "
          f"{k_grads[0].item():.6g} vs {p_grads[0].item():.6g}")
    expect(abs(k_loss - p_loss) <= 2e-2, "LoRA kernel route loss disagrees with the plain route")
    expect(min(cos) >= 0.999, "LoRA kernel route gradients disagree with the plain route")
    del plain, k_grads, p_grads, batches, adapters, opt
    tmp.cleanup()
    check(not failed, "LoRA phase: " + "; ".join(failed))
    return launches


def check_bucket_kernels(torch, ref, kernels, shapes, randn, cfg):
    """The training kernels against their plain versions at each (B, L)
    that the data-plane, resume and launcher phases trained on, with the
    tolerances of the kernels' own checks: the attention forward and backward at (B, L, heads, head dim),
    the cross-entropy forward and backward and the LayerNorm forward and
    backward at B·L rows."""
    fwd, bwd = kernels["flash_attention_fwd"], kernels["flash_attention_bwd"]
    ce_fwd, ce_bwd, ln = kernels["cross_entropy_fwd"], kernels["cross_entropy_bwd"], kernels["layernorm"]
    ln_bwd = kernels["layernorm_bwd"]
    H, D, d = cfg.num_heads, cfg.d_model // cfg.num_heads, cfg.d_model
    for B, L in sorted(shapes):
        q, k, v, do = (randn(B, L, H, D) for _ in range(4))
        out, lse = fwd(q, k, v, causal=False)
        grads = bwd(q, k, v, out, lse, do, causal=False)
        r_out, r_lse = ref.attention_ref(q, k, v, causal=False)
        e_out = (out.float() - r_out.float()).abs().max().item()
        e_lse = (lse - r_lse).abs().max().item()
        e_bwd = max(rel_err(g, w) for g, w in zip(grads, ref.attention_bwd_ref(q, k, v, out, lse, do,
                                                                               causal=False)))
        del q, k, v, do, out, lse, grads, r_out, r_lse
        T = B * L
        h = randn(T, d)
        w = randn(cfg.padded_vocab, d, scale=0.05).T
        gen = torch.Generator(h.device).manual_seed(B * 10007 + L)
        tgt = torch.randint(0, cfg.vocab_size, (T,), device=h.device, generator=gen,
                            dtype=torch.int32)
        gl = torch.full((T,), 1.0 / T, device=h.device)
        gs = torch.zeros(T, device=h.device)
        loss, lse = ce_fwd(h, w, tgt, vocab=cfg.vocab_size)
        dh, dw = ce_bwd(h, w, tgt, lse, gl, gs, vocab=cfg.vocab_size)
        r_loss, r_lse = ref.cross_entropy_ref(h, w, tgt, cfg.vocab_size)
        r_dh, r_dw = ref.cross_entropy_bwd_ref(h, w, tgt, r_lse, gl, gs, cfg.vocab_size)
        e_ce = max((loss - r_loss).abs().max().item(), (lse - r_lse).abs().max().item())
        e_ce_bwd = max(rel_err(dh, r_dh), rel_err(dw, r_dw))
        x = randn(T, d, scale=3.0, shift=1.0)
        lw, lb = randn(d, dtype=torch.float32), randn(d, dtype=torch.float32)
        y, r = ln(x, lw, lb).float(), ref.layernorm_ref(x, lw, lb).float()
        ln_ok = bool(((y - r).abs() <= 1e-2 + 2**-7 * r.abs()).all())
        lw, lb, dy = lw.to(torch.bfloat16), lb.to(torch.bfloat16), randn(T, d)
        ln_bwd_ok, ln_bwd_errs = layernorm_bwd_grads_ok(
            torch, ln_bwd(x, lw, lb, dy), ref.layernorm_bwd_ref(x, lw, lb, dy), torch.bfloat16)
        print(f"kernels at bucket shape ({B}, {L}): attention out {e_out:.3g} (tol 3e-2), lse "
              f"{e_lse:.3g} (1e-4), backward {e_bwd:.3g} (2e-2 of max|ref|); cross-entropy "
              f"loss/lse {e_ce:.3g} (2e-4), backward {e_ce_bwd:.3g} (2e-2); layernorm within "
              f"1e-2 + 2^-7|y|: {ln_ok}; its backward's err / tol "
              f"{', '.join(f'{e:.3g}' for e in ln_bwd_errs)} (<= 1)")
        check(e_out <= 3e-2 and e_lse <= 1e-4 and e_bwd <= 2e-2, f"attention at bucket ({B}, {L})")
        check(e_ce <= 2e-4 and e_ce_bwd <= 2e-2, f"cross-entropy at bucket ({B}, {L})")
        check(ln_ok, f"layernorm at bucket ({B}, {L})")
        check(ln_bwd_ok, f"layernorm_bwd at bucket ({B}, {L})")
        del h, w, dh, dw, r_dh, r_dw, x, y, r, dy
        torch.cuda.empty_cache()


def data_plane_phase(torch, counters, card):
    """ESM-2 650M MLM training at full width and depth through the data
    plane: the train phase's 1 024 sequences in a sharded store (shards of
    2^16 tokens), ``SizeAwareSampler`` (8 192 padded tokens a batch, a
    ``ClusterSampler`` base) feeding ``MLMBatches`` behind a
    ``BackgroundProducer`` (depth 4), 10 ``Trainer.run`` steps at accum 1;
    then the same through the ``ClusterSampler`` alone at 8 x 1024, the
    train phase's micro-batch.  Each run starts from the train phase's
    initial weights (``build_model(seed=0)``), so the two are comparable
    and the loss falls as it does from an initialization.  Gates: a finite, falling loss, no skipped
    step, every batch within budget, at most ten shapes, each step's
    launches.  Returns the launch counts of the size-aware run and of the
    ClusterSampler run, and the (B, L) shapes of both, for
    ``check_bucket_kernels``."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.config import ParallelConfig, TrainConfig
    from repro_torch.data.dataset import build_synthetic_protein_store
    from repro_torch.data.pipeline import MLMBatches
    from repro_torch.data.producer import BackgroundProducer
    from repro_torch.data.sampler import ClusterSampler, greedy_length_clusters
    from repro_torch.data.size_aware import SizeAwareSampler
    from repro_torch.models.model import build_model
    from repro_torch.training.loop import Trainer

    cfg = get_config("esm2-650m")
    steps, seq, budget = 10, 1024, 8192
    tmp = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    store, tok = build_synthetic_protein_store(f"{tmp.name}/store", n=1024, seed=0,
                                               shard_tokens=1 << 16, min_len=100, max_len=1023)
    lengths = np.minimum(store.lengths(), seq)
    print(f"data plane: the train phase's {len(store)} sequences in a sharded store of "
          f"{store.num_shards} shards ({store.total_tokens} tokens) in "
          f"{time.perf_counter() - t0:.1f} s")
    tc = TrainConfig(global_batch=8, seq_len=seq, learning_rate=1e-4, min_lr=1e-5, warmup_steps=2,
                     decay_steps=3, total_steps=steps, schedule="wsd", weight_decay=0.01,
                     beta2=0.98, grad_clip=1.0, log_every=steps)
    # the models below are built with the default ParallelConfig
    one_step = step_launches(cfg.num_layers, ParallelConfig().remat_policy)
    failed = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    def run(sampler, label):
        pipe = BackgroundProducer(MLMBatches(store, tok, sampler, 8, seq,
                                             mask_prob=cfg.mlm_mask_prob, seed=0), depth=4)
        trainer = Trainer(build_model(cfg, device="cuda", seed=0), tc, verbose=False)
        per_step = []     # (shape, its launches, its real tokens on the device)
        step_fn = trainer._step_fn

        def spy(state, batch):
            before = {n: fn.launches for n, fn in counters.items()}
            out = step_fn(state, batch)
            per_step.append((tuple(batch["tokens"].shape),
                             {n: fn.launches - before[n] for n, fn in counters.items()},
                             (batch["targets"] != tok.pad_id).sum()))
            return out

        trainer._step_fn = spy
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        try:
            _, hist = trainer.run(pipe)
        finally:
            pipe.close()
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in counters.items()}
        shapes = [sh for sh, _, _ in per_step]
        real = torch.stack([r for _, _, r in per_step]).tolist()
        step_s = hist[-1]["step_time"]         # steps 1-9: their wall over 9
        real_s = sum(real[1:]) / (step_s * (steps - 1))
        padded = [b * L for b, L in shapes]
        share = 1 - sum(real) / sum(padded)
        losses = [h["loss"] for h in hist]
        print(f"main path: Trainer.run of {steps} steps, {label}: launches {launches}; shapes "
              f"{shapes}")
        print(f"{label} on {card}: step {step_s * 1e3:.1f} ms (steps 1-{steps - 1}, one host "
              f"transfer), {real_s:.0f} real tokens/s, {sum(padded[1:]) / (step_s * (steps - 1)):.0f} "
              f"padded tokens/s, padded share {share:.3f} ({sum(real)} real of {sum(padded)}), "
              f"{len(set(shapes))} distinct (B, L); losses step 0 {losses[0]:.4f}, step "
              f"{steps - 1} {losses[-1]:.4f}")
        expect(len(hist) == 2 and all(np.isfinite(losses)), f"{label}: non-finite loss")
        expect(losses[-1] < losses[0], f"{label}: the loss did not fall")
        expect(trainer.skipped_total == 0, f"{label}: {trainer.skipped_total} skipped steps")
        expect(all(p <= budget for p in padded), f"{label}: a batch over budget")
        expect(all(n == one_step for _, n, _ in per_step), f"{label}: launches of a step")
        expect(launches == {k: v * steps for k, v in one_step.items()}, f"{label}: launch counts")
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        return launches, shapes, real_s, share

    base = ClusterSampler(greedy_length_clusters(lengths, 64), seed=0)
    sa_launches, shapes, sa_real, sa_share = run(
        SizeAwareSampler(lengths, budget, base=base), "size-aware (sharded store, 8192-token "
        "budget, ClusterSampler base, producer depth 4)")
    expect(len(set(shapes)) <= 10, "more than ten (B, L) shapes")
    cl_launches, cl_shapes, cl_real, cl_share = run(
        ClusterSampler(greedy_length_clusters(lengths, 64), seed=0),
        "ClusterSampler 8x1024 (sharded store, producer depth 4)")
    print(f"size-aware vs ClusterSampler on {card}: real tokens/s {sa_real:.0f} vs {cl_real:.0f} "
          f"({sa_real / cl_real:.3f}x), padded share {sa_share:.3f} vs {cl_share:.3f}")
    tmp.cleanup()
    check(not failed, "data-plane phase: " + "; ".join(failed))
    return sa_launches, cl_launches, set(shapes) | set(cl_shapes)


def resume_phase(torch, counters, card):
    """A bit-exact resume on the card through the launcher's data plane:
    ESM-2 650M at full width, 2 of its 33 layers, ``make_batches`` (sharded
    store, 8 192-token size-aware batches, producer depth 2), ``Trainer``
    with a checkpoint every 3 of 6 steps; a second run resumed from
    ``step_3`` must end with the first run's params and moments bit for
    bit.  Returns the launch counts of the uninterrupted run and the (B, L)
    shapes of both runs."""
    from repro_torch.configs import get_config
    from repro_torch.core.config import TrainConfig
    from repro_torch.core.module import tree_leaves
    from repro_torch.launch.train import make_batches
    from repro_torch.models.model import build_model
    from repro_torch.training.loop import Trainer

    cfg = dataclasses.replace(get_config("esm2-650m"), num_layers=2)
    model = build_model(cfg, device="cuda", seed=0)
    tmp = tempfile.TemporaryDirectory()
    tc = TrainConfig(global_batch=8, seq_len=1024, learning_rate=1e-4, warmup_steps=2,
                     decay_steps=3, total_steps=6, log_every=2, ckpt_dir=f"{tmp.name}/ck",
                     ckpt_every=3)
    shapes = []

    def run(**kw):
        batches = make_batches(cfg, tc, f"{tmp.name}/data", sharded=True, max_tokens=8192,
                               producer_depth=2)
        trainer = Trainer(model, tc, verbose=False)
        step_fn = trainer._step_fn
        trainer._step_fn = lambda st, b: (shapes.append(tuple(b["tokens"].shape)),
                                          step_fn(st, b))[1]
        try:
            state, hist = trainer.run(batches, **kw)
        finally:
            batches.close()
        return state.clone(), hist

    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    s1, h1 = run()
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    s2, h2 = run(resume_from=f"{tmp.name}/ck/step_3")
    torch.cuda.synchronize()
    x = tree_leaves(s1.params) + tree_leaves(s1.opt.mu) + tree_leaves(s1.opt.nu)
    y = tree_leaves(s2.params) + tree_leaves(s2.opt.mu) + tree_leaves(s2.opt.nu)
    differ = sum(not torch.equal(a.detach(), b.detach()) for a, b in zip(x, y))
    want = {k: v * 6 for k, v in step_launches(cfg.num_layers, model.pc.remat_policy).items()}
    print(f"main path: resume on {card}: ESM-2 650M width, 2 of 33 layers, 6 steps with "
          f"checkpoints {sorted(os.listdir(f'{tmp.name}/ck'))}, then steps 4-6 resumed from "
          f"step_3 ({time.perf_counter() - t0:.1f} s): shapes {shapes[:6]} then {shapes[6:]}; "
          f"launches {launches} (want {want}); {differ} of {len(x)} final param and moment "
          f"leaves differ; losses {h1[-1]['loss']:.6f} vs {h2[-1]['loss']:.6f}")
    check(shapes[6:] == shapes[3:6], "the resumed run drew other batches")
    check(differ == 0 and int(s1.opt.step) == int(s2.opt.step) == 6,
          "the resumed run differs from the uninterrupted run")
    check(launches == want, "resume launch counts")
    del model, s1, s2, x, y
    tmp.cleanup()
    return launches, set(shapes)


def launcher_phase(torch, counters, card):
    """``repro_torch.launch.train.main`` on the card: ESM-2 650M at full
    width and depth, 4 steps of 8 192-token size-aware batches from the
    sharded store behind a producer, with ``--profile``: it must reach its
    final line, print the step timer and leave a trace.  Returns the launch
    counts of its run and the (B, L) shapes its trainer stepped on."""
    import contextlib
    import io

    from repro_torch.configs import get_config
    from repro_torch.core.config import ParallelConfig
    from repro_torch.launch import train as launch_train

    shapes = []

    class Recording(launch_train.Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            step_fn = self._step_fn
            self._step_fn = lambda st, b: (shapes.append(tuple(b["tokens"].shape)),
                                           step_fn(st, b))[1]

    tmp = tempfile.TemporaryDirectory()
    argv = ["--arch", "esm2-650m", "--steps", "4", "--seq", "1024", "--sharded-data",
            "--max-tokens-per-batch", "8192", "--producer", "2", "--mesh", "none",
            "--profile", f"{tmp.name}/prof", "--data-dir", f"{tmp.name}/data"]
    for fn in counters.values():
        fn.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    trainer_cls, launch_train.Trainer = launch_train.Trainer, Recording
    try:
        with contextlib.redirect_stdout(out):
            launch_train.main(argv)
    finally:
        launch_train.Trainer = trainer_cls
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    text = out.getvalue()
    traces = [f for f in os.listdir(f"{tmp.name}/prof") if f.endswith(".pt.trace.json")]
    mb = sum(os.path.getsize(f"{tmp.name}/prof/{f}") for f in traces) / 1e6
    # launch.train.main builds its model with the default ParallelConfig
    want = {k: v * 4 for k, v in step_launches(get_config("esm2-650m").num_layers,
                                               ParallelConfig().remat_policy).items()}
    keep = [ln for ln in text.splitlines() if ln.startswith(("arch=", "step ", "  train_step",
                                                             "final loss"))]
    print(f"main path: launch.train.main {' '.join(argv[:-4])} ({time.perf_counter() - t0:.1f} s, "
          f"trace {traces} {mb:.1f} MB): shapes {shapes}; launches {launches} (want {want})")
    print("launcher: " + " | ".join(keep))
    check("step timer:" in text and "train_step: n=4" in text, "the launcher printed no step timer")
    check(text.rstrip().splitlines()[-1].startswith("final loss"), "the launcher did not finish")
    check(len(traces) == 1 and mb > 0, "the launcher left no trace")
    check(launches == want, "launcher launch counts")
    tmp.cleanup()
    return launches, set(shapes)


# the launcher's own run in the mesh phase, as a user starts it; at the
# launcher's default peak lr (1e-3, warmup 1 step) ESM-2 650M's loss rises
# in its first steps, so the run takes 1e-5
MESH_LAUNCH = ["--arch", "esm2-650m", "--mesh", "1x1", "--steps", "3", "--batch", "8",
               "--seq", "1024", "--lr", "1e-5"]


def mesh_train_phase(torch, counters, card):
    """Slice 8's training half on the card, in a world of one process over
    NCCL (a file store in a temporary directory): ESM-2 650M at full width
    and depth trains 3 steps of 8 x 1024 (MLM, remat ``block``) through the
    sharded ``Trainer`` on a (1, 1) mesh, and through the mesh-free
    ``Trainer`` on the same seeded batches (the ESM-2 training phase's
    pipeline).  Each step's loss and grad norm, the gradient digest of the
    first batch, the fp32 params after the third step and the launch counts
    must be equal.  Prints one more mesh step's device ms, wall ms, idle
    share, peak memory and the device ms of its collectives.  Then
    ``launch.train`` under ``torchrun --standalone --nproc_per_node 1`` with
    ``MESH_LAUNCH`` must finish with a falling loss.  Returns the mesh run's
    launch counts and its figures."""
    import re

    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.config import ParallelConfig, TrainConfig
    from repro_torch.core.module import tree_leaves
    from repro_torch.data.dataset import build_synthetic_protein_memmap
    from repro_torch.data.pipeline import MLMBatches
    from repro_torch.data.sampler import ClusterSampler, greedy_length_clusters
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import build_model
    from repro_torch.training.loop import Trainer
    from repro_torch.training.train_step import make_train_step

    cfg = get_config("esm2-650m")
    steps, micro, seq = 3, 8, 1024
    tc = TrainConfig(global_batch=micro, seq_len=seq, learning_rate=1e-4, min_lr=1e-5,
                     warmup_steps=1, decay_steps=2, total_steps=steps, schedule="wsd",
                     weight_decay=0.01, beta2=0.98, grad_clip=1.0, log_every=1)
    tmp = tempfile.TemporaryDirectory()
    ds, tok = build_synthetic_protein_memmap(f"{tmp.name}/prot", n=1024, seed=0, min_len=100,
                                             max_len=1023)

    def pipe():
        sampler = ClusterSampler(greedy_length_clusters(ds.lengths(), 64), seed=0)
        return MLMBatches(ds, tok, sampler, micro, seq, mask_prob=cfg.mlm_mask_prob, seed=0)

    failed = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    def run(model):
        """(gradient digest of the first batch, [(loss, grad norm)] a step,
        launches, trainer) of a fresh model."""
        first = {k: torch.from_numpy(v).to(model.device) for k, v in next(iter(pipe())).items()}
        params = model.params.tree()
        loss, _ = model.loss_fn(model.compute_params(params), first)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        digest = tree_digest(torch, {f"{i:04d}": g for i, g in enumerate(grads)})
        del grads, loss
        for fn in counters.values():
            fn.launches = 0
        trainer = Trainer(model, tc, verbose=False)
        _, hist = trainer.run(pipe())
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in counters.items()}
        return digest, [(h["loss"], h["grad_norm"]) for h in hist], launches, trainer

    t0 = time.perf_counter()
    free = build_model(cfg, device="cuda", seed=0)
    f_digest, f_hist, f_launches, trainer = run(free)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    t_free = time.perf_counter() - t0
    dist.init_process_group("nccl", store=dist.FileStore(f"{tmp.name}/store", 1), rank=0,
                            world_size=1)
    try:
        t0 = time.perf_counter()
        mesh = make_test_mesh((1, 1), ("data", "model"))
        model = build_model(cfg, ParallelConfig(), mesh, device="cuda", seed=0)
        digest, hist, launches, trainer = run(model)
        t_mesh = time.perf_counter() - t0
        differ = [i for i, (a, b) in enumerate(zip(tree_leaves(model.params.tree()),
                                                    tree_leaves(free.params.tree())))
                  if not torch.equal(a, b)]
        n_leaves = len(tree_leaves(free.params.tree()))
        del free
        gc.collect()
        torch.cuda.empty_cache()
        want = {k: v * steps for k, v in step_launches(cfg.num_layers, "block").items()}
        print(f"main path: sharded Trainer.run on a (1, 1) mesh over NCCL ({model.pc}), ESM-2 "
              f"650M, {steps} steps of {micro}x{seq} ({t_mesh:.1f} s; the mesh-free run "
              f"{t_free:.1f} s): launches {launches} (mesh-free {f_launches}, want {want})")
        print(f"mesh vs mesh-free: losses and grad norms {hist} vs {f_hist}; first-batch gradient "
              f"digest {digest} vs {f_digest}; {len(differ)} of {n_leaves} fp32 param leaves "
              f"differ after step {steps}")
        expect(hist == f_hist, "the mesh run's losses or grad norms differ from the mesh-free run")
        expect(digest == f_digest, "the mesh run's gradients differ from the mesh-free run's")
        expect(not differ, "the mesh run's params differ from the mesh-free run's")
        expect(launches == f_launches == want, "mesh training launch counts")
        expect(all(math.isfinite(x) for h in hist for x in h), "non-finite loss")

        # one more step of the mesh path: its cost, and what its collectives take
        batch = {k: torch.from_numpy(v).to(model.device) for k, v in next(iter(pipe())).items()}
        step_fn = make_train_step(model, tc)
        state = trainer.state
        step_fn(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step_fn(state, batch)
            torch.cuda.synchronize()
            prof_wall_ms = (time.perf_counter() - t0) * 1e3
        busy_ms, groups, kern = kernel_groups(prof, DeviceType)
        comm = [(n, t, c) for n, t, c in kern if "nccl" in n.lower()]
        copies = [(n, t, c) for n, t, c in kern if "memcpy" in n.lower()]
        nccl_ms = sum(t for _, t, _ in comm)
        print(f"mesh train step (ESM-2 650M, {micro}x{seq}, (1, 1) mesh, NCCL world of one) on "
              f"{card}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms (under the profiler: "
              f"wall {prof_wall_ms:.1f} ms, idle share {1 - busy_ms / prof_wall_ms:.3f}), peak "
              f"memory {peak_gb:.2f} GB; NCCL kernels {nccl_ms:.3f} ms a step ("
              + ", ".join(f"{n[:60]} {t:.3f} ms {c}x" for n, t, c in comm) + "); device copies "
              + ", ".join(f"{n[:40]} {t:.3f} ms {c}x" for n, t, c in copies))
        print("mesh step by group: " + ", ".join(f"{k} {v:.1f} ms" for k, v in groups.items() if v))
        figures = {"wall_ms": wall_ms, "device_ms": busy_ms,
                   "idle_share": 1 - busy_ms / prof_wall_ms, "peak_gb": peak_gb,
                   "nccl_ms": nccl_ms, "nccl_kernels": [[n, t, c] for n, t, c in comm],
                   "copies": [[n, t, c] for n, t, c in copies]}
        del model, trainer, state, step_fn, prof
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # the entry point a user runs: the launcher under torchrun
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
           "-m", "repro_torch.launch.train", *MESH_LAUNCH, "--data-dir", f"{tmp.name}/data"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                       capture_output=True, text=True, timeout=600)
    final = [ln for ln in r.stdout.splitlines() if ln.startswith(("arch=", "step ", "final loss"))]
    print(f"main path: torchrun --standalone --nproc_per_node 1 -m repro_torch.launch.train "
          f"{' '.join(MESH_LAUNCH)} ({time.perf_counter() - t0:.1f} s): rc {r.returncode}; "
          + " | ".join(final))
    m = re.search(r"final loss ([0-9.]+) \(from ([0-9.]+)\)", r.stdout)
    if r.returncode != 0:
        print(r.stderr[-3000:])
    expect(r.returncode == 0 and m is not None, "the launcher under torchrun failed")
    expect(m is not None and float(m.group(1)) < float(m.group(2)),
           "the launcher's loss did not fall")
    figures["launcher_losses"] = [float(m.group(2)), float(m.group(1))] if m else None
    tmp.cleanup()
    check(not failed, "mesh training phase: " + "; ".join(failed))
    return launches, figures


MESH_SERVE_LAUNCH = ["--arch", "qwen2-7b", "--mesh", "1x1", "--continuous", "--cache-layout",
                     "paged", "--prefix-cache", "--prefill-chunk", "512", "--batch", "8",
                     "--requests", "8", "--prompt-len", "512", "--gen", "8", "--health-every", "0"]
MESH_SERVE_ROWS = ("flash_attention_fwd", "rmsnorm", "flash_decode", "fused_sample", "paged_decode",
                   "paged_prefill", "paged_kv_write")
TP2_DEPTH = 8          # Qwen2-7B's layers in the two-rank phase (of 28)
TP2_STEPS = 8          # its forced decode steps


def serve_decode_profile(torch, eng, prompts, steps=8, profiled=True, sync=None):
    """Per steady decode step of ``eng``: wall ms, device busy ms and NCCL
    kernel ms (the profiler), and the ``torch.distributed.all_reduce`` calls
    and their host ms.  ``prompts`` (one a slot) are admitted for 64 tokens
    each and run past their last prefill first; ``profiled=False`` steps
    without the profiler (its device figures None).  ``sync``, when given,
    runs just before the clock starts (the ranks of a world meet there, the
    profiler's start-up behind them)."""
    import numpy as np
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.engine import Request
    from repro_torch.serving.sampling import SamplingParams

    for i, p in enumerate(prompts[:eng.slots]):
        eng.submit(Request(uid=70_000 + i, prompt=np.asarray(p, np.int32),
                           params=SamplingParams(max_new=64)))
    while eng.queue or eng._prefilling:
        eng.step()
    for _ in range(2):
        eng.step()
    calls = [0, 0.0]
    real = dist.all_reduce

    def counted(*a, **kw):
        t0 = time.perf_counter()
        out = real(*a, **kw)
        calls[0] += 1
        calls[1] += time.perf_counter() - t0
        return out

    dist.all_reduce = counted
    try:
        torch.cuda.synchronize()
        ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if profiled
               else None)
        with ctx if ctx is not None else contextlib.nullcontext():
            if sync is not None:
                sync()
            t0 = time.perf_counter()
            for _ in range(steps):
                eng.step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        dist.all_reduce = real
    out = {"wall_ms": wall / steps, "all_reduces": calls[0] / steps,
           "all_reduce_host_ms": calls[1] * 1e3 / steps, "device_ms": None, "nccl_ms": None,
           "idle_share": None}
    if ctx is not None:
        busy, _, kern = kernel_groups(ctx, DeviceType)
        out.update(device_ms=busy / steps, idle_share=1 - busy / wall,
                   nccl_ms=sum(t for n, t, _ in kern if "nccl" in n.lower()) / steps)
    return out


def mesh_serve_phase(torch, counters, card, free):
    """Slice 8's serving half on the card, in a world of one process over
    NCCL (a file store in a temporary directory): Qwen2-7B at full width and
    depth (bf16 parameters, built from seed 0 on a (1, 1) mesh) serves 16
    prompts of the generation load (64-1 024 tokens, the odd ones sampled
    with their log-probabilities), 16 new tokens each, on 8 slots through
    ``LLM.generate``, over the dense cache and over the paged one with
    prefix caching (the even prompts behind one 512-token preamble) and
    512-token chunks.  Its tokens, log-probabilities and each row's launches
    must equal the mesh-free engine's on ``free`` (the dense phase's model,
    the same seed) bit for bit, and no collective may run in a decode step
    (at ``model`` = 1 there is none; read over 8 steady dense steps).
    ESM-2 650M's ``LLM.embed`` on a (1, 1) mesh must equal the mesh-free
    embeddings bit for bit.  Prints each engine's steady dense decode step
    (wall, device, NCCL ms) and its peak memory.
    Returns the mesh runs' launch counts and the figures."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.config import ParallelConfig
    from repro_torch.data.tokenizer import ProteinTokenizer
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import build_model
    from repro_torch.serving.api import LLM

    failed = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    cfg = free.cfg
    n, slots, new = 16, 8, 16
    lengths, prompts, params = generation_load(np, cfg.vocab_size, n, new)
    pre = np.random.default_rng(5).integers(0, cfg.vocab_size, size=512).tolist()
    paged_prompts = [pre + p if i % 2 == 0 else p for i, p in enumerate(prompts)]
    layouts = {"dense": (dict(slots=slots, max_len=2048), prompts),
               "paged": (dict(slots=slots, max_len=2048, cache_layout="paged", page_size=16,
                              prefix_cache=True, prefill_chunk=512), paged_prompts)}
    rows = [r for r in MESH_SERVE_ROWS if r in counters]

    def run(model, layout):
        kw, load = layouts[layout]
        llm = LLM(model, **kw)
        for r in rows:
            counters[r].launches = 0
        counters["paged_decode"].appends = 0
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        outs = llm.generate(load, params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {r: counters[r].launches for r in rows}
        launches["paged_decode.appends"] = counters["paged_decode"].appends
        # a steady decode step's figures, on the dense cache alone (one
        # layout keeps the phase short)
        fig = serve_decode_profile(torch, llm.engine, load) if layout == "dense" else {}
        fig.update(peak_gb=torch.cuda.max_memory_allocated() / 1e9, resident_gb=resident,
                   generate_s=wall, tokens=sum(len(c.tokens) for c in outs))
        stats = dict(llm.engine.alloc.stats) if llm.engine.alloc is not None else {}
        got = ([c.tokens for c in outs], [c.logprobs for c in outs], launches, fig, stats)
        del llm
        gc.collect()
        torch.cuda.empty_cache()
        return got

    t0 = time.perf_counter()
    want = {layout: run(free, layout) for layout in layouts}
    t_free = time.perf_counter() - t0
    free_gb = sum(p.numel() * p.element_size() for p in free.parameters()) / 1e9
    tok = ProteinTokenizer()
    rng = np.random.default_rng(6)
    seqs = [tok.encode("".join(rng.choice(list(AMINO_ACIDS), size=int(L) - 2)))
            for L in rng.integers(30, 1023, size=32)]
    esm_cfg = get_config("esm2-650m")
    esm = build_model(esm_cfg, device="cuda", seed=0)
    emb_rows = ("flash_attention_fwd", "layernorm")

    def embed(model):
        for r in emb_rows:
            counters[r].launches = 0
        vecs = LLM(model, slots=32, max_len=1024).embed(seqs)
        return vecs, {r: counters[r].launches for r in emb_rows}

    f_vecs, f_emb = embed(esm)
    del esm
    tmp = tempfile.TemporaryDirectory()
    dist.init_process_group("nccl", store=dist.FileStore(f"{tmp.name}/store", 1), rank=0,
                            world_size=1)
    figures = {}
    try:
        mesh = make_test_mesh((1, 1), ("data", "model"))
        t0 = time.perf_counter()
        model = build_model(cfg, ParallelConfig(), mesh, device="cuda", seed=0)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        got = {layout: run(model, layout) for layout in layouts}
        launches = {}
        for layout in layouts:
            toks, lps, lc, fig, stats = got[layout]
            f_toks, f_lps, f_lc, f_fig, f_stats = want[layout]
            same_toks, same_lps = toks == f_toks, lps == f_lps
            print(f"main path: LLM.generate on a (1, 1) mesh over NCCL, Qwen2-7B bf16, {layout} "
                  f"({n} prompts x {new} new on {slots} slots): tokens = the mesh-free engine's "
                  f"{same_toks}, log-probabilities bit for bit {same_lps}; launches {lc} "
                  f"(mesh-free {f_lc}); prefix stats {stats} (mesh-free {f_stats})")
            print(f"  {layout}: peak {fig['peak_gb']:.2f} GB ({fig['resident_gb']:.2f} GB resident "
                  f"before the engine, the mesh-free model's {free_gb:.2f} among them), mesh-free "
                  f"{f_fig['peak_gb']:.2f} GB")
            if "wall_ms" in fig:
                print(f"  {layout} steady decode step on {card}: mesh wall {fig['wall_ms']:.2f} "
                      f"ms, device {fmt_ms(fig['device_ms'])} ms, NCCL {fmt_ms(fig['nccl_ms'])} "
                      f"ms, {fig['all_reduces']:g} all-reduces a step; mesh-free wall "
                      f"{f_fig['wall_ms']:.2f} ms, device {fmt_ms(f_fig['device_ms'])} ms")
                expect(fig["all_reduces"] == 0, f"{layout}: an all-reduce ran at model = 1")
            expect(same_toks and same_lps, f"{layout}: the mesh engine's tokens differ")
            expect(lc == f_lc, f"{layout}: the mesh engine's launches differ")
            launches[layout] = lc
            figures[layout] = {"mesh": fig, "free": f_fig}
        del model, got
        gc.collect()
        torch.cuda.empty_cache()
        esm = build_model(esm_cfg, ParallelConfig(), mesh, device="cuda", seed=0)
        vecs, emb = embed(esm)
        del esm
        same = bool(np.array_equal(vecs, f_vecs))
        print(f"main path: ESM-2 650M LLM.embed of {len(seqs)} sequences on a (1, 1) mesh: = the "
              f"mesh-free embeddings bit for bit {same}; launches {emb} (mesh-free {f_emb})")
        expect(same and emb == f_emb, "the mesh embeddings differ from the mesh-free ones")
        launches["embed"] = emb
        figures["qwen2_mesh_build_s"] = t_build
        figures["free_runs_s"] = t_free
    finally:
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
    tmp.cleanup()
    check(not failed, "mesh serving phase: " + "; ".join(failed))
    return launches, figures


def mesh_serve_launch(card):
    """The serving launcher a user runs on a mesh: ``launch.serve`` under
    ``torchrun --standalone --nproc_per_node 1`` with ``MESH_SERVE_LAUNCH``
    (Qwen2-7B at full width and depth, fp32 master weights, their bf16
    serving view) must serve every request and exit 0."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
           "-m", "repro_torch.launch.serve", *MESH_SERVE_LAUNCH]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                       capture_output=True, text=True, timeout=600)
    lines = [ln for ln in r.stdout.splitlines() if "served" in ln or "health" in ln]
    secs = time.perf_counter() - t0
    print(f"main path: torchrun --standalone --nproc_per_node 1 -m repro_torch.launch.serve "
          f"{' '.join(MESH_SERVE_LAUNCH)} on {card} ({secs:.1f} s): rc {r.returncode}; "
          + " | ".join(lines))
    if r.returncode != 0:
        print(r.stderr[-3000:])
    check(r.returncode == 0 and any("served 8/8 requests" in ln for ln in lines),
          "the serving launcher under torchrun --mesh 1x1 failed")
    return secs


def tp2_inputs(np, vocab):
    """The two-rank phase's load: 8 prompts of the generation load and
    ``TP2_STEPS`` forced tokens a slot, and its two engine layouts."""
    _, prompts, _ = generation_load(np, vocab, 8, 16, seed=3)
    forced = np.random.default_rng(4).integers(0, vocab, size=(TP2_STEPS, 8)).astype(np.int32)
    layouts = {"dense": dict(slots=8, max_len=2048),
               "paged": dict(slots=8, max_len=2048, cache_layout="paged", page_size=16,
                             prefix_cache=True, prefill_chunk=512)}
    return prompts, forced, layouts


def tp2_config():
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("qwen2-7b"), param_dtype="bfloat16",
                               num_layers=TP2_DEPTH)


TP2_ROWS = ("flash_attention_fwd", "rmsnorm", "flash_decode", "fused_sample", "paged_decode",
            "paged_prefill")


def tp2_counters():
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.paged_attention import paged_decode, paged_prefill
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.sampling import fused_sample

    return dict(zip(TP2_ROWS, (flash_attention_fwd, rmsnorm, flash_decode, fused_sample,
                               paged_decode, paged_prefill)))


def tp2_child(rank: int, d: str) -> None:
    """One of the two ranks of ``mesh_serve_tp2_phase``, on ``cuda:0``: joins
    a Gloo world of two over a file store in ``d``, builds the phase's
    Qwen2-7B on a (1, 2) mesh (head-TP: 14 query and 2 K/V heads, 9 472 of
    the 18 944 MLP columns a rank) and runs ``engine_logits`` over the
    dense and the paged layout, counting each row's launches; rank 0
    writes the logits.  Then a steady decode step's figures (rank 0 under
    the profiler) and the rank's peak memory, into ``d/rank<r>.json``."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core.config import ParallelConfig
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import build_model
    from repro_torch.parallel.sharding import rank_kv_heads
    from repro_torch.serving.api import LLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(f"{d}/store", 2), rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=600))
    try:
        counters = tp2_counters()
        cfg = tp2_config()
        prompts, forced, layouts = tp2_inputs(np, cfg.vocab_size)
        mesh = make_test_mesh((1, 2), ("data", "model"))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = build_model(cfg, ParallelConfig(), mesh, device="cuda", seed=0)
        torch.cuda.synchronize()
        gb = {"weights": torch.cuda.memory_allocated() / 1e9,
              "build_peak": torch.cuda.max_memory_allocated() / 1e9}
        view = model.serving_params()
        gb["weights_and_view"] = torch.cuda.memory_allocated() / 1e9
        layer = view["layers"]["sub0"]
        out = {"build_s": time.perf_counter() - t0, "launches": {}, "gb": gb,
               "q_heads": layer["attn"]["wq"].shape[-1] // cfg.resolved_head_dim,
               "kv_heads": rank_kv_heads(cfg, model.ctx),
               "d_ff": layer["ffn"]["w_in"].shape[-1]}
        del view, layer
        forced_d = torch.as_tensor(forced, device="cuda")
        for layout, kw in layouts.items():
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            lg, _ = engine_logits(torch, np, model, kw, prompts, forced_d)
            torch.cuda.synchronize()
            out["launches"][layout] = {r: fn.launches for r, fn in counters.items()}
            out[f"{layout}_s"] = time.perf_counter() - t0
            gb[f"{layout}_peak"] = torch.cuda.max_memory_allocated() / 1e9
            if rank == 0:
                torch.save(lg.cpu(), f"{d}/logits_{layout}.pt")
            del lg
            # engine_logits's spies hold its engine (and the engine's view of
            # the weights) in a reference cycle: collect it before the next
            gc.collect()
            torch.cuda.empty_cache()
        llm = LLM(model, slots=8, max_len=2048)
        out["decode"] = serve_decode_profile(torch, llm.engine, prompts, profiled=rank == 0,
                                             sync=dist.barrier)
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        with open(f"{d}/rank{rank}.json", "w") as f:
            json.dump(out, f)
        del llm, model
    finally:
        dist.destroy_process_group()


def mesh_serve_tp2_phase(torch, counters, card):
    """Two head-TP ranks on the one card: Qwen2-7B at full width with
    ``TP2_DEPTH`` of its 28 layers (bf16 parameters, seed 0) on a (1, 2)
    mesh, each rank a process on ``cuda:0`` in a Gloo world of two (NCCL
    takes one rank a GPU).  Against the mesh-free engine at the same depth
    on the same card: ``engine_logits`` over 8 prompts, the first token and
    ``TP2_STEPS`` forced decode steps, dense and paged (prefix caching,
    512-token chunks); logit cosine >= 0.999 and top-1 equal where decided
    (``compare_logits(..., margin=2.0)``: the bf16 partial sums of ``wo``
    and ``w_out`` are added over two ranks, so bits may move); each rank's
    launches of rows 1 and 6-10 equal the mesh-free run's.  Prints each
    rank's steady decode step (wall, device on rank 0, its all-reduces and
    their host ms: a correctness phase, not a speed figure) and peak memory.
    Returns the ranks' launch counts and figures."""
    import numpy as np

    from repro_torch.models.model import build_model

    failed = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    cfg = tp2_config()
    prompts, forced, layouts = tp2_inputs(np, cfg.vocab_size)
    free = build_model(cfg, device="cuda", seed=0)
    forced_d = torch.as_tensor(forced, device="cuda")
    want, want_launches = {}, {}
    for layout, kw in layouts.items():
        for r in TP2_ROWS:
            counters[r].launches = 0
        want[layout], _ = engine_logits(torch, np, free, kw, prompts, forced_d)
        want_launches[layout] = {r: counters[r].launches for r in TP2_ROWS}
    del free
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.TemporaryDirectory()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    logs = [open(f"{tmp.name}/rank{r}.log", "w") for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--tp2-rank", str(r),
                               tmp.name], env=env, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    secs = time.perf_counter() - t0
    if rcs != [0, 0]:
        for r in range(2):
            print(f"--- tp2 rank {r} (rc {rcs[r]}) ---\n"
                  + Path(f"{tmp.name}/rank{r}.log").read_text()[-3000:])
    check(rcs == [0, 0], f"the two-rank serving world failed: rcs {rcs}")
    ranks = [json.loads(Path(f"{tmp.name}/rank{r}.json").read_text()) for r in range(2)]
    for r, res in enumerate(ranks):
        print(f"main path: rank {r} of (1, 2) over Gloo on {card}, Qwen2-7B {TP2_DEPTH} layers: "
              f"{res['q_heads']} query heads, K/V heads {res['kv_heads']}, d_ff {res['d_ff']}; "
              f"built in {res['build_s']:.1f} s; launches {res['launches']} (mesh-free "
              f"{want_launches}); peak {res['peak_gb']:.2f} GB (GB allocated or peak by stage: "
              f"{res['gb']}); steady decode step {res['decode']}")
        expect(res["launches"] == want_launches, f"rank {r}: launches differ from the mesh-free run")
        expect(res["q_heads"] == 14 and res["kv_heads"] == [2 * r, 2 * r + 1]
               and res["d_ff"] == 9472, f"rank {r}: not the head-TP rank shapes")
    cosines = {}
    for layout in layouts:
        got = torch.load(f"{tmp.name}/logits_{layout}.pt").to(want[layout].device)
        cosines[layout] = compare_logits(torch, got, want[layout],
                                         f"two ranks on (1, 2) vs the mesh-free engine, {layout}",
                                         expect, margin=2.0)
    tmp.cleanup()
    print(f"the two-rank phase took {secs:.1f} s (two processes on one card)")
    check(not failed, "two-rank serving phase: " + "; ".join(failed))
    return {"launches": [res["launches"] for res in ranks], "want": want_launches,
            "cosine": cosines, "decode": [res["decode"] for res in ranks],
            "peak_gb": [res["peak_gb"] for res in ranks], "seconds": secs}


def check_rmsnorm(torch, F, ref, rmsnorm, randn, card):
    """Row 6 against ``rmsnorm_ref`` at the served widths (Mamba2's 2560,
    Qwen2-7B's 3584, Scout's 5120, InternVL2's 6144, Llama-3-405B's 16384,
    the kernel's widest row) at the decode and prefill row counts, in bf16
    and fp32, and with weights in another dtype than x; times Qwen2's decode
    and prefill shapes, Scout's decode shape, Llama-3's two and InternVL2's
    decode step and image-and-prompt prefill, and reads each shape's
    device time over inputs rotated past the 50 MB L2.
    Returns its kernel record, timed at the decode shape the main path runs
    most (launches filled in later)."""
    import itertools

    cases = [(rows, d, dt, dt) for d in (2560, 3584, 5120, 6144, 16384) for rows in (32, 2048)
             for dt in (torch.bfloat16, torch.float32)]
    cases += [(32, 3584, torch.bfloat16, torch.float32), (32, 3584, torch.float32, torch.bfloat16),
              (32, 3584, torch.float16, torch.float16), (7, 256, torch.bfloat16, torch.bfloat16)]
    for rows, d, dt, wdt in cases:
        x = randn(rows, d, dtype=dt, scale=3.0, shift=0.5)
        w = randn(d, dtype=wdt)
        y = rmsnorm(x, w)
        torch.cuda.synchronize()
        r = ref.rmsnorm_ref(x, w)
        err = (y.float() - r.float()).abs()
        # 16-bit output: at most one output rounding step apart (2^-7 of
        # |y| in bf16); fp32: the same moments summed in another order
        rtol = {torch.bfloat16: 2**-7, torch.float16: 2**-10, torch.float32: 1e-5}[dt]
        ok = bool((err <= 1e-5 + rtol * r.float().abs()).all()) and y.dtype == dt
        print(f"rmsnorm ({rows}, {d}) x {str(dt)[6:]}, w {str(wdt)[6:]}: max err "
              f"{err.max().item():.3g} (tol 1e-5 + {rtol:.3g}*|y|)")
        check(ok, f"rmsnorm ({rows}, {d}) {dt} w {wdt}")
    rec = None
    for rows, d in ((32, 3584), (2048, 3584), (32, 5120), (32, 16384), (2048, 16384), (32, 6144),
                    (1280, 6144)):
        x = randn(rows, d, scale=3.0, shift=0.5)
        w = randn(d)
        # the kernel and F.rms_norm in turns (kernel, library, library,
        # kernel): both are bound by the host's launch path at these sizes,
        # and the host's speed drifts within a run
        turns = {"kernel": [], "library": []}
        for who in ("kernel", "library", "library", "kernel"):
            turns[who].append(time_ms(torch, (lambda: rmsnorm(x, w)) if who == "kernel"
                                      else (lambda: F.rms_norm(x, (d,), w, 1e-5))))
        ms, lib_ms = (statistics.mean(turns[who]) for who in ("kernel", "library"))
        plain_ms = time_ms(torch, lambda: ref.rmsnorm_ref(x, w))
        nbytes = 2 * rows * d * 2 + d * 2
        bound_ms, bound_by = bound(4 * rows * d, nbytes, PEAK_FP32_FLOPS)
        dev_ms = device_ms(torch, lambda: rmsnorm(x, w), "rmsnorm", floor=bound_ms)
        # the same shape over enough inputs that each call reads x from
        # DRAM, as a layer's norm does: its reading against the byte bound
        copies = -(-3 * 50 * 2**20 // (rows * d * 2))
        xs = itertools.cycle([randn(rows, d, scale=3.0, shift=0.5) for _ in range(copies)])
        dram_ms = device_ms(torch, lambda: rmsnorm(next(xs), w), "rmsnorm", floor=bound_ms)
        del xs
        print(f"rmsnorm ({rows}, {d}) bf16 on {card}: {ms:.4f} ms back to back, device {fmt_ms(dev_ms)} "
              f"ms, over {copies} inputs rotated past L2 {fmt_ms(dram_ms)} ms (bound {bound_ms:.5f} "
              f"ms by {bound_by}, {per_device_ms(nbytes, dram_ms, 'GB/s', 1e6)}), plain "
              f"{plain_ms:.4f} ms, F.rms_norm {lib_ms:.4f} ms")
        reading = {"ms": ms, "device_ms": dev_ms, "device_ms_dram": dram_ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}
        if rec is None:
            err = (rmsnorm(x, w).float() - ref.rmsnorm_ref(x, w).float()).abs().max().item()
            rec = {"name": "rmsnorm", "route": "cuda", "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
                   "replaces": "src/repro/kernels/rmsnorm.py:54", "launches": 0,
                   "max_abs_err": err, **reading}
        else:
            rec[f"({rows}, {d})"] = reading
    return rec


# flash_decode's output bits on ``flash_decode_bits``'s inputs, as the
# parent of the fused paged insert gave them (``decode_variants.py
# --parent`` prints the parent's and the tree's): the split body that
# flash_decode shares with paged_decode (``csrc/decode_split.cuh``) keeps
# its bits, and with them Scout's route statistic
FLASH_DECODE_BITS = "133938a2565538c8"


def flash_decode_bits(torch, call) -> str:
    """sha256 (16 hex digits) of the bf16 output of ``call(q, k, v,
    lengths)`` at Qwen2-7B's decode shape (B 32, T 2048, 28 / 4 heads of
    128; lengths 0, 1 and T among them) on inputs that numpy makes from
    seed 5, so that the digest depends on the kernel alone."""
    import hashlib

    import numpy as np

    rng = np.random.default_rng(5)
    B, T, H, Hkv, D = 32, 2048, 28, 4, 128
    dev = torch.device("cuda")

    def arr(*shape):
        x = rng.standard_normal(shape, dtype=np.float32)
        return torch.from_numpy(x).to(dev).to(torch.bfloat16)

    q, k, v = arr(B, 1, H, D), arr(B, T, Hkv, D), arr(B, T, Hkv, D)
    lens = rng.integers(0, T + 1, size=B)
    lens[:3] = [0, 1, T]
    out = call(q, k, v, torch.as_tensor(lens, dtype=torch.int32, device=dev))
    return hashlib.sha256(out.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]


def check_flash_decode(torch, F, ref, flash_decode, randn, card):
    """Row 8 against ``decode_attention_ref`` at Qwen2-7B's and Scout's
    decode shapes with ragged lengths (0, 1 and T among them), at the
    256-key split edges, at groups 1 and 16, at D 64, with a softcap and
    through strided views of a stacked cache, in bf16 (the only dtype the
    kernel takes); a row alone must equal its row in the batch bit for bit,
    a repeat the first call, and its bits on ``flash_decode_bits``'s inputs
    the parent's (``FLASH_DECODE_BITS``).  Times the served decode shapes:
    Qwen2's, Scout's, the zoo decoders', InternVL2's and Whisper's
    cross-attention.  Returns its kernel record (Qwen2's shape; Scout's
    under "scout", the others under their label)."""
    import numpy as np

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    # the plain version rounds the normalized P to bf16 before PV; the
    # kernel rounds the unnormalized P to bf16 for the tensor cores and
    # divides by the fp32 sum at the end
    tol = 2e-2
    edges = [0, 255, 256, 257, 511, 512, 1, 767]
    # the zoo's decoders mid-way through their main call (prompts of
    # 64-1 024 tokens, 32 of 64 generated); InternVL2's 256 image rows in
    # front; Whisper's cross-attention, every row at the 1 500 frames
    mid = np.random.default_rng(2).integers(64 + 32, 1024 + 33, size=32)
    cases = [
        ("qwen2-7b decode shape", dict(B=32, T=2048, H=28, Hkv=4, D=128, timed=True)),
        ("scout decode shape, group 5", dict(B=32, T=2048, H=40, Hkv=8, D=128, timed=True)),
        ("command-r-35b decode shape, group 8", dict(B=32, T=2048, H=64, Hkv=8, D=128, timed=True,
                                                     lens=mid)),
        ("qwen1.5-32b decode shape, group 1", dict(B=32, T=2048, H=40, Hkv=40, D=128, timed=True,
                                                   lens=mid)),
        ("llama3-405b decode shape, group 16", dict(B=32, T=2048, H=128, Hkv=8, D=128, timed=True,
                                                    lens=mid)),
        ("internvl2-26b decode shape, group 6", dict(B=32, T=1344, H=48, Hkv=8, D=128, timed=True,
                                                     lens=mid + 256)),
        ("whisper-medium cross decode, D=64, group 1", dict(B=32, T=1500, H=16, Hkv=16, D=64,
                                                            timed=True, lens=[1500] * 32)),
        ("split edges", dict(B=8, T=768, H=28, Hkv=4, D=128, lens=edges)),
        ("group 1", dict(B=8, T=700, H=8, Hkv=8, D=128)),
        ("group 16", dict(B=4, T=900, H=32, Hkv=2, D=128)),
        ("D=64, group 4", dict(B=8, T=333, H=16, Hkv=4, D=64)),
        ("D=64, group 16", dict(B=4, T=520, H=16, Hkv=1, D=64, lens=[0, 1, 256, 520])),
        ("softcap 30", dict(B=8, T=600, H=28, Hkv=4, D=128, softcap=30.0)),
        ("strided stacked-cache views", dict(B=8, T=640, H=28, Hkv=4, D=128, strided=True)),
        # a head-TP rank's share of the heads (tensor-parallel serving)
        ("qwen2-7b rank at model=2, group 7", dict(B=32, T=2048, H=14, Hkv=2, D=128, lens=mid)),
        ("qwen2-7b rank at model=4, group 7", dict(B=32, T=2048, H=7, Hkv=1, D=128, lens=mid)),
        ("llama3-405b rank at model=8, group 16", dict(B=32, T=2048, H=16, Hkv=1, D=128,
                                                       lens=mid)),
    ]
    shapes = {}
    for label, c in cases:
        B, T, H, Hkv, D = c["B"], c["T"], c["H"], c["Hkv"], c["D"]
        cap = c.get("softcap", 0.0)
        if "lens" in c:
            lens = np.asarray(c["lens"])
        else:
            lens = rng.integers(0, T + 1, size=B)
            lens[:3] = [0, 1, T]
        lengths = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        q = randn(B, 1, H, D)
        if c.get("strided"):
            # a layer's K and V as views of one (B, T, 2, Hkv, D) buffer
            kv = randn(B, T, 2, Hkv, D)
            k, v = kv[:, :, 0], kv[:, :, 1]
        else:
            k = randn(B, T, Hkv, D)
            v = randn(B, T, Hkv, D)
        out = flash_decode(q, k, v, lengths, softcap=cap)
        torch.cuda.synchronize()
        want = ref.decode_attention_ref(q, k, v, lengths, softcap=cap)
        err = row_rel_err(out, want)
        zero = bool((out[lengths == 0] == 0).all())
        repeat = torch.equal(flash_decode(q, k, v, lengths, softcap=cap), out)
        # each row alone (a batch of one) against its row in the batch
        alone = all(torch.equal(flash_decode(q[i:i + 1], k[i:i + 1], v[i:i + 1], lengths[i:i + 1],
                                             softcap=cap), out[i:i + 1])
                    for i in range(min(B, 6)))
        print(f"flash_decode {label} (B={B}, T={T}, H={H}, Hkv={Hkv}, D={D}, softcap {cap}) bf16: rel "
              f"err {err:.3g} (tol {tol} of each row's max|ref|), length-0 rows exactly 0: {zero}, "
              f"repeat bit-identical: {repeat}, rows alone = in the batch: {alone}")
        check(err <= tol and zero and repeat and alone and bool(out.isfinite().all()),
              f"flash_decode {label}")
        if c.get("timed"):
            shapes[label] = (q, k, v, lengths, lens, (out.float() - want.float()).abs().max().item())
    bits = flash_decode_bits(torch, flash_decode)
    print(f"flash_decode bits at qwen2-7b's decode shape on numpy-seeded inputs: {bits} (the "
          f"parent's {FLASH_DECODE_BITS})")
    check(bits == FLASH_DECODE_BITS, "flash_decode's bits moved from the parent's")
    recs = {}
    for label, (q, k, v, lengths, lens, err0) in shapes.items():
        B, T, Hkv, D = k.shape
        H = q.shape[2]
        ms = time_ms(torch, lambda: flash_decode(q, k, v, lengths))
        plain_ms = time_ms(torch, lambda: ref.decode_attention_ref(q, k, v, lengths), trials=5,
                           per_trial=5)
        qt = q.transpose(1, 2)                                   # (B, H, 1, D)
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)            # (B, Hkv, T, D)
        mask = (torch.arange(T, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                                       enable_gqa=True))
        live = int(lens.sum())
        # this run's data: q and out once, each live cache row of K and V
        # once, the lengths; QK and PV of every query head over its live rows
        nbytes = 2 * B * H * D * 2 + 2 * live * Hkv * D * 2 + B * 4
        bound_ms, bound_by = bound(4 * H * D * live, nbytes)
        dev_ms = device_ms(torch, lambda: flash_decode(q, k, v, lengths), "flash_decode",
                           floor=bound_ms)
        print(f"flash_decode {label} B={B} T={T} H={H} Hkv={Hkv} D={D} bf16, {live} live rows of "
              f"{B * T}, on {card}: {ms:.4f} ms back to back, device {fmt_ms(dev_ms)} ms (bound "
              f"{bound_ms:.4f} ms by {bound_by}, {per_device_ms(nbytes, dev_ms, 'GB/s', 1e6)}), "
              f"plain {plain_ms:.4f} ms, scaled_dot_product_attention (length mask, GQA) "
              f"{lib_ms:.4f} ms")
        recs[label] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": lib_ms, "max_abs_err": err0}
    first, scout, *rest = recs
    rec = {"name": "flash_decode", "route": "cuda", "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
           "replaces": "src/repro/kernels/flash_decode.py:116", "launches": 0, **recs[first]}
    rec["scout"] = recs[scout]
    rec.update({label: recs[label] for label in rest})
    return rec


# per row, in turn: greedy, top-k only, top-p only, both, temperature 0
# with filters set, plain temperature
SAMPLE_MIX = [(0.0, 0, 1.0), (0.8, 50, 1.0), (1.0, 0, 0.95), (0.8, 50, 0.95), (0.0, 50, 0.9),
              (1.3, 0, 1.0)]
# the edges, in turn: greedy, top-k 1, top-k >= V (off), a tiny top-p, both
# filters, plain temperature, temperatures 0.3 and 2
SAMPLE_EDGES = [(0.0, 0, 1.0), (0.7, 1, 1.0), (1.0, -1, 0.9), (0.9, 0, 1e-6), (0.8, 50, 0.95),
                (1.3, 0, 1.0), (0.3, 20, 0.8), (2.0, 0, 0.99)]


def sample_inputs(torch, randn, B, V, rows, ties=False):
    """Logits (B, V) bf16 with every 97th column masked (-1e30) and half of
    row 5 masked, the per-row (temperature, top_k, top_p) of ``rows`` in
    turn (top_k -1: V + 5), seeds past 2^31 and steps; ``ties``: rows 0 and
    1 get a three-way tie at the top (columns 3, V // 2, V - 1)."""
    dev = torch.device("cuda")
    x = randn(B, V, scale=2.0)
    x[:, torch.arange(0, V, 97, device=dev)] = -1e30
    if B > 5:
        x[5, : V // 2] = -1e30
    if ties:
        for r in range(min(B, 2)):
            x[r, [3, V // 2, V - 1]] = (x[r].float().max() + 1.0).to(x.dtype)
    rows = [rows[i % len(rows)] for i in range(B)]
    temp = torch.tensor([r[0] for r in rows], device=dev)
    top_k = torch.tensor([V + 5 if r[1] < 0 else r[1] for r in rows], dtype=torch.int32, device=dev)
    top_p = torch.tensor([r[2] for r in rows], device=dev)
    seed = torch.tensor([(2**31 + 977 * i) % 2**32 for i in range(B)], device=dev).to(torch.int32)
    step = torch.tensor([3 * i for i in range(B)], dtype=torch.int32, device=dev)
    return x, temp, top_k, top_p, seed, step


def check_sampling(torch, ref, fused_sample, randn, card):
    """Row 7 against ``sample_ref``: at Qwen2-7B's decode shape (32, 152064)
    with the mix of rows, then at Mamba2's 50 432, Scout's padded 202 240
    and Command-R's 256 000 columns (the mix and the edges), a small odd V
    (1 000), one row, and a V past what a cluster
    holds in shared memory, each over the edges (top-k 1 and >= V, a tiny
    top-p, ties at the top, temperatures 0.3-2): identical tokens, logp
    within 1e-4, greedy rows = first-index argmax, no masked column drawn,
    a repeat bit-identical, and each row alone equal (token and logp bits)
    to its row in the batch.  Times the mix, all-greedy and all-sampled
    rows at the main shape, and the mix at every other served vocabulary.
    Returns its kernel record."""
    from repro_torch.kernels import _build

    cases = [("qwen2-7b decode shape, the mix", 32, 152064, SAMPLE_MIX, False),
             ("mamba2 vocab 50432, edges", 32, 50432, SAMPLE_EDGES, True),
             ("scout padded vocab 202240, edges", 32, 202240, SAMPLE_EDGES, True),
             ("command-r vocab 256000, the mix", 32, 256000, SAMPLE_MIX, False),
             ("command-r vocab 256000, edges", 32, 256000, SAMPLE_EDGES, True),
             ("molmim vocab 768, 64 rows, the mix", 64, 768, SAMPLE_MIX, False),
             ("whisper vocab 51968, edges", 32, 51968, SAMPLE_EDGES, True),
             ("internvl2 vocab 92672, edges", 32, 92672, SAMPLE_EDGES, True),
             ("V 1000, edges", 16, 1000, SAMPLE_EDGES, True),
             ("one row", 1, 152064, SAMPLE_EDGES[3:4], False),
             ("V 600000, past shared memory", 4, 600000, SAMPLE_EDGES, True)]
    lib = _build.load("sampling")
    main = None
    for label, B, V, rows, ties in cases:
        args = sample_inputs(torch, randn, B, V, rows, ties)
        x, temp = args[0], args[1]
        tok, logp = fused_sample(*args)
        torch.cuda.synchronize()
        r_tok, r_logp = ref.sample_ref(*args)
        same = int((tok == r_tok).sum())
        err = (logp - r_logp).abs().max().item()
        masked = bool((x.gather(1, tok.long()[:, None]) > -1e29).all())
        greedy = temp <= 0
        argmax_ok = bool((tok[greedy] == x[greedy].float().argmax(dim=-1).to(torch.int32)).all())
        t2, l2 = fused_sample(*args)
        repeat = torch.equal(t2, tok) and torch.equal(l2, logp)
        alone = True
        for i in range(B):
            ta, la = fused_sample(*(a[i:i + 1] for a in args))
            alone &= torch.equal(ta, tok[i:i + 1]) and torch.equal(la.view(torch.int32),
                                                                   logp[i:i + 1].view(torch.int32))
        waves = -(-B // max(lib.fused_sample_max_clusters(V), 1))
        print(f"fused_sample {label} ({B}, {V}) bf16: {same}/{B} tokens equal to the plain "
              f"version's, logp err {err:.3g} (tol 1e-4), no masked column drawn: {masked}, "
              f"greedy rows = first-index argmax: {argmax_ok}, repeat bit-identical: {repeat}, "
              f"rows alone = in the batch: {alone}; {lib.fused_sample_max_clusters(V)} clusters "
              f"of {lib.fused_sample_cluster()} resident ({waves} wave(s))")
        check(same == B and err <= 1e-4 and masked and argmax_ok and repeat and alone,
              f"fused_sample {label}")
        if main is None:
            main = (args, err)
    args, err = main
    x, temp, top_k, top_p, seed, step = args
    B, V = x.shape
    ms = time_ms(torch, lambda: fused_sample(*args))
    plain_ms = time_ms(torch, lambda: ref.sample_ref(*args), trials=5, per_trial=2)
    zeros = torch.zeros_like(temp)
    greedy_ms = time_ms(torch, lambda: fused_sample(x, zeros, top_k, top_p, seed, step))
    hot = torch.full_like(temp, 0.8)
    sampled_ms = time_ms(torch, lambda: fused_sample(x, hot, top_k, top_p, seed, step), trials=5)
    # the function reads the logits once and writes two scalars a row
    bound_ms, bound_by = bound(0, B * V * 2 + B * 20 + B * 8)
    dev_ms = device_ms(torch, lambda: fused_sample(*args), "fused_sample", floor=bound_ms)
    print(f"fused_sample ({B}, {V}) bf16 on {card}: mix {ms:.4f} ms (device {fmt_ms(dev_ms)} ms; bound "
          f"{bound_ms:.5f} ms by "
          f"{bound_by}), all greedy {greedy_ms:.4f} ms, all sampled {sampled_ms:.4f} ms; plain "
          f"{plain_ms:.4f} ms; no single PyTorch call samples with this hash (library: none)")
    rec = {"name": "fused_sample", "route": "cuda", "source": "src/repro_torch/kernels/csrc/sampling.cu",
           "replaces": "src/repro/kernels/sampling.py:217", "launches": 0, "max_abs_err": err,
           "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": None, "greedy_ms": greedy_ms,
           "sampled_ms": sampled_ms}
    # the mix at the other served vocabularies: MolMIM's 768 (64 rows of
    # its static batch), Mamba2's 50 432, Whisper's 51 968, InternVL2's
    # 92 672, Scout's 202 240 and Command-R's 256 000 (past what a
    # cluster's shared memory holds: each pass re-reads the slice's tail)
    for B, V in ((64, 768), (32, 50432), (32, 51968), (32, 92672), (32, 202240), (32, 256000)):
        args = sample_inputs(torch, randn, B, V, SAMPLE_MIX)
        v_bound_ms, v_bound_by = bound(0, B * V * 2 + B * 28)
        reading = {"ms": time_ms(torch, lambda: fused_sample(*args)),
                   "device_ms": device_ms(torch, lambda: fused_sample(*args), "fused_sample",
                                          floor=v_bound_ms),
                   "plain_ms": time_ms(torch, lambda: ref.sample_ref(*args), trials=5, per_trial=2),
                   "bound_ms": v_bound_ms, "bound_by": v_bound_by, "library_ms": None}
        print(f"fused_sample ({B}, {V}) bf16 on {card}: the mix {reading['ms']:.4f} ms (device "
              f"{fmt_ms(reading['device_ms'])} ms; bound {v_bound_ms:.5f} ms by {v_bound_by}), "
              f"plain {reading['plain_ms']:.4f} ms")
        rec[f"({B}, {V})"] = reading
    return rec


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


def check_paged_decode(torch, F, ref, paged_decode, flash_decode, randn, card):
    """Row 9 against ``paged_decode_attention_ref`` at Qwen2-7B's decode
    shape over the default pool (4 097 pages of 16, 128 a row): ragged
    lengths that are not page multiples, a length-0 row, null-page entries
    past each length, shuffled page order; and at group 1 with pages of 8,
    at D 64, and with pages of 32, and at head-TP ranks' shares of the
    heads (Qwen2-7B at model 2 and 4, Llama-3-405B at 8).  Each case: within 2e-2 of each row's
    max, length-0 rows exactly 0, a repeat bit-identical, each row alone
    bit-equal to its row in the batch, and the output bit-equal to
    ``flash_decode`` over the same rows gathered into a dense cache (the
    two share their split body; at a page of 8 the stage is read row by
    row, at 16 and 32 a page at a time); and at the served shapes of
    Command-R, Whisper and InternVL2.  Times the main shape and the served
    ones beside SDPA over the pre-gathered cache and beside the gather and
    SDPA together.  Returns its kernel record (the others under their
    label)."""
    import numpy as np

    dev = torch.device("cuda")
    rng = np.random.default_rng(9)
    tol = 2e-2   # the plain version rounds the normalized P to bf16 before PV
    # the served paged shapes mid-way through their main call, each over
    # the engine's default pool: Command-R's (flash_decode's lengths),
    # Whisper's self-attention (prompts of 4-64 tokens) and InternVL2's
    mid = np.random.default_rng(2).integers(64 + 32, 1024 + 33, size=32)
    cases = [
        ("qwen2-7b decode shape", dict(B=32, cap=2048, H=28, Hkv=4, D=128, page=16, P=4097)),
        ("group 1, page 8", dict(B=8, cap=704, H=8, Hkv=8, D=128, page=8, P=712)),
        ("D=64, group 4", dict(B=8, cap=336, H=16, Hkv=4, D=64, page=16, P=170)),
        ("page 32, group 7", dict(B=8, cap=1024, H=28, Hkv=4, D=128, page=32, P=260)),
        ("command-r-35b decode shape, group 8", dict(B=32, cap=2048, H=64, Hkv=8, D=128, page=16,
                                                     P=4097, lens=mid)),
        ("whisper-medium self decode, D=64, group 1", dict(
            B=32, cap=448, H=16, Hkv=16, D=64, page=16, P=897,
            lens=np.random.default_rng(3).integers(4 + 32, 64 + 33, size=32))),
        ("internvl2-26b decode shape, group 6", dict(B=32, cap=1344, H=48, Hkv=8, D=128, page=16,
                                                     P=2689, lens=mid + 256)),
        # head-TP ranks' shares of the heads over their pools (not timed)
        ("qwen2-7b rank at model=2, group 7", dict(B=32, cap=2048, H=14, Hkv=2, D=128, page=16,
                                                   P=4097, lens=mid, rank=True)),
        ("qwen2-7b rank at model=4, group 7", dict(B=32, cap=2048, H=7, Hkv=1, D=128, page=16,
                                                   P=4097, lens=mid, rank=True)),
        ("llama3-405b rank at model=8, group 16", dict(B=32, cap=2048, H=16, Hkv=1, D=128,
                                                       page=16, P=4097, lens=mid, rank=True)),
    ]
    main, timed = None, {}
    for label, c in cases:
        B, cap, H, Hkv, D, page, P = (c[x] for x in ("B", "cap", "H", "Hkv", "D", "page", "P"))
        if "lens" in c:
            lens = np.array(c["lens"])
        elif main is None:     # the lengths of flash_decode's main case (31 163 live rows)
            lens = np.random.default_rng(1).integers(0, cap + 1, size=B)
            lens[:3] = [0, 1, cap]
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
        zero = bool((out[lengths == 0] == 0).all())
        repeat = torch.equal(paged_decode(q, k_pool, v_pool, bt, lengths), out)
        alone = all(torch.equal(paged_decode(q[i:i + 1], k_pool, v_pool, bt[i:i + 1],
                                             lengths[i:i + 1]), out[i:i + 1])
                    for i in range(min(B, 6)))
        dense = torch.equal(flash_decode(q, ref._gather_pages(k_pool, bt),
                                         ref._gather_pages(v_pool, bt), lengths), out)
        print(f"paged_decode {label} (B={B}, capacity {cap}, H={H}, Hkv={Hkv}, D={D}, page {page}, "
              f"{P} pages) bf16: rel err {err:.3g} (tol {tol} of each row's max|ref|), length-0 row "
              f"exactly 0: {zero}, repeat bit-identical: {repeat}, rows alone = in the batch: "
              f"{alone}, = flash_decode over the gathered rows bit for bit: {dense}")
        check(err <= tol and zero and repeat and alone and dense and bool(out.isfinite().all()),
              f"paged_decode {label}")
        if main is None or ("lens" in c and not c.get("rank")):
            timed[label] = (q, k_pool, v_pool, bt, lengths, lens,
                            (out.float() - want.float()).abs().max().item())
            main = main or label
    readings = {label: time_paged_decode(torch, F, ref, paged_decode, *args, card)
                for label, args in timed.items()}
    rec = {"name": "paged_decode", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
           "replaces": "src/repro/kernels/paged_attention.py:135", "launches": 0,
           **readings.pop(main)}
    rec.update(readings)
    return rec


def time_paged_decode(torch, F, ref, paged_decode, q, k_pool, v_pool, bt, lengths, lens, err0,
                      card):
    """One timed shape of row 9: back to back, on the device, its bound,
    the plain version, SDPA over the cache gathered beforehand and the
    gather and SDPA together."""
    dev = q.device
    B, _, H, D = q.shape
    page, Hkv = k_pool.shape[1], k_pool.shape[2]
    T = bt.shape[1] * page
    ms = time_ms(torch, lambda: paged_decode(q, k_pool, v_pool, bt, lengths))
    plain_ms = time_ms(torch, lambda: ref.paged_decode_attention_ref(q, k_pool, v_pool, bt, lengths),
                       trials=5, per_trial=5)
    # the yardsticks: no single PyTorch call reads through a block table, so
    # SDPA over the cache gathered beforehand (the gather not timed), and the
    # gather and SDPA together (the same work as the kernel)
    kt = ref._gather_pages(k_pool, bt).transpose(1, 2)
    vt = ref._gather_pages(v_pool, bt).transpose(1, 2)
    mask = (torch.arange(T, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    qt = q.transpose(1, 2)
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                                   enable_gqa=True))
    gather_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, ref._gather_pages(k_pool, bt).transpose(1, 2),
        ref._gather_pages(v_pool, bt).transpose(1, 2), attn_mask=mask, enable_gqa=True))
    del kt, vt
    live = int(lens.sum())
    # this run's data: q and out once, each live K and V row once, the
    # lengths and the table rows; QK and PV of every query head over its
    # live rows
    nbytes = 2 * B * H * D * 2 + 2 * live * Hkv * D * 2 + B * 4 + bt.numel() * 4
    bound_ms, bound_by = bound(4 * H * D * live, nbytes)
    dev_ms = device_ms(torch, lambda: paged_decode(q, k_pool, v_pool, bt, lengths), "paged_decode",
                       floor=bound_ms)
    print(f"paged_decode B={B} capacity {T} H={H} Hkv={Hkv} D={D} page {page} bf16, {live} live rows "
          f"of {B * T}, on {card}: {ms:.4f} ms back to back, device {fmt_ms(dev_ms)} ms (bound "
          f"{bound_ms:.4f} ms by {bound_by}, {per_device_ms(nbytes, dev_ms, 'GB/s', 1e6)}), "
          f"plain {plain_ms:.4f} ms, scaled_dot_product_attention over the pre-gathered dense "
          f"cache (length mask, GQA) {lib_ms:.4f} ms, the page gather and SDPA together "
          f"{gather_ms:.4f} ms")
    return {"max_abs_err": err0, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "gather_sdpa_ms": gather_ms}


def check_paged_prefill(torch, F, ref, paged_prefill, flash_attention_fwd, randn, card):
    """Row 10 against ``paged_prefill_attention_ref`` at Qwen2-7B's chunk
    shape (a 512-token chunk, H 28, Hkv 4, D 128, pages of 16): at start 0,
    at start 512 over pages shared with another row (a cached preamble),
    with fewer valid rows than the bucket, and at a 64-token bucket; at
    page 8, group 1, D 64 with a fully masked row; at page 12 (rows
    gathered one by one); and at head-TP ranks' shares of the heads
    (Qwen2-7B at model 2 and 4, Llama-3-405B at 8).  Each case within 2e-2 of each query row's max,
    and each row bit-equal to ``flash_attention_fwd`` with q_offset = start
    over the same rows gathered into a dense cache of length lengths[b]
    (the two share their consumer body and key tiles).  Times the
    start-512 chunk and the 64-token bucket beside SDPA over the
    pre-gathered cache, the gather and SDPA together, and the dense forward
    over the gathered rows.  Returns its kernel record."""
    import numpy as np

    dev = torch.device("cuda")
    rng = np.random.default_rng(10)
    tol = 2e-2   # as the attention forward: P rounded to bf16 before PV

    def dense_equal(q, k_pool, v_pool, bt, st, ln, out):
        """Whether each row with a key equals the dense forward over its
        gathered rows bit for bit, and the largest difference."""
        worst, equal = 0.0, True
        for b in range(q.shape[0]):
            L = int(ln[b])
            if L == 0:
                continue
            kd = ref._gather_pages(k_pool, bt[b:b + 1])[:, :L]
            vd = ref._gather_pages(v_pool, bt[b:b + 1])[:, :L]
            want, _ = flash_attention_fwd(q[b:b + 1], kd, vd, causal=True, q_offset=int(st[b]))
            equal &= torch.equal(want, out[b:b + 1])
            worst = max(worst, (want.float() - out[b:b + 1].float()).abs().max().item())
        return equal, worst

    H, Hkv, D, page, P, n_tables = 28, 4, 128, 16, 4097, 128
    pools = (randn(P, page, Hkv, D), randn(P, page, Hkv, D))
    # two rows that share their first 32 pages (a 512-token preamble)
    base = _paged_layout(torch, np, rng, [2048, 2048], page, n_tables, P, dev)
    base[1, :32] = base[0, :32]
    k12, v12 = randn(200, 12, 2, D), randn(200, 12, 2, D)
    bt12 = _paged_layout(torch, np, rng, [300, 100], 12, 30, 200, dev)
    k8, v8 = randn(300, 8, 4, 64), randn(300, 8, 4, 64)
    bt8 = _paged_layout(torch, np, rng, [200, 0], 8, 30, 300, dev)
    # head-TP ranks' pools: Qwen2-7B's 2 K/V heads at model 2, one at model
    # 4 (and Llama-3-405B's one at model 8), two rows over 1 024 positions
    pools2 = (randn(140, page, 2, D), randn(140, page, 2, D))
    pools1 = (randn(140, page, 1, D), randn(140, page, 1, D))
    bt_rank = _paged_layout(torch, np, rng, [1024, 1024], page, 64, 140, dev)
    cases = [  # label, (S, H, pools, table), starts, valid rows
        ("512-token chunk at start 0", (512, H, pools, base), [0, 0], [512, 512]),
        ("512-token chunk at start 512 over shared pages", (512, H, pools, base), [512, 512],
         [512, 300]),
        ("64-token bucket, 37 valid, start 1000", (64, H, pools, base), [1000, 530], [37, 64]),
        ("page 8, group 1, D=64, a fully masked row", (40, 4, (k8, v8), bt8), [150, 0], [40, 0]),
        ("page 12 (rows gathered one by one), group 7", (200, 14, (k12, v12), bt12), [130, 0],
         [170, 100]),
        ("qwen2-7b rank at model=2, 512-token chunk, group 7", (512, 14, pools2, bt_rank),
         [512, 0], [512, 300]),
        ("qwen2-7b rank at model=4, 512-token chunk, group 7", (512, 7, pools1, bt_rank),
         [512, 0], [512, 512]),
        ("llama3-405b rank at model=8, 512-token chunk, group 16", (512, 16, pools1, bt_rank),
         [0, 256], [512, 512]),
    ]
    recs = {}
    for label, (S, h, (kp, vp), bt), starts, valid in cases:
        B = len(starts)
        q = randn(B, S, h, kp.shape[3])
        st = torch.tensor(starts, dtype=torch.int32, device=dev)
        ln = torch.tensor([s + v for s, v in zip(starts, valid)], dtype=torch.int32, device=dev)
        out = paged_prefill(q, kp, vp, bt, st, ln)
        torch.cuda.synchronize()
        want = ref.paged_prefill_attention_ref(q, kp, vp, bt, st, ln)
        err = row_rel_err(out, want, dims=2)
        zero = bool((out[ln == 0] == 0).all())
        equal, worst = dense_equal(q, kp, vp, bt, st, ln, out)
        print(f"paged_prefill {label} (B={B}, S={S}, valid {valid}, H={h}, Hkv={kp.shape[2]}, "
              f"D={kp.shape[3]}, page {kp.shape[1]}) bf16: rel err {err:.3g} (tol {tol} of each "
              f"query row's max|ref|), rows of length 0 exactly 0: {zero}, = flash_attention_fwd "
              f"over the gathered rows bit for bit: {equal} (max |diff| {worst:.3g})")
        check(err <= tol and zero and equal and bool(out.isfinite().all()),
              f"paged_prefill {label}")
        if "start 512" in label or "bucket" in label:
            recs[label] = (q[:1], bt[:1], st[:1], ln[:1],
                           (out[:1].float() - want[:1].float()).abs().max().item())

    def timed(q, bt, st, ln):
        S = q.shape[1]
        start, L = int(st[0]), int(ln[0])
        fn = lambda: paged_prefill(q, *pools, bt, st, ln)     # noqa: E731
        T = bt.shape[1] * page
        kt = ref._gather_pages(pools[0], bt).transpose(1, 2)
        vt = ref._gather_pages(pools[1], bt).transpose(1, 2)
        kpos = torch.arange(T, device=dev)
        qpos = start + torch.arange(S, device=dev)
        mask = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] < L)
        qt = q.transpose(1, 2)
        kd, vd = kt.transpose(1, 2)[:, :L].contiguous(), vt.transpose(1, 2)[:, :L].contiguous()
        fwd = lambda: flash_attention_fwd(q, kd, vd, causal=True, q_offset=start)   # noqa: E731
        # QK and PV over each query row's visible keys; q and out once, the
        # live K and V rows once, the table row
        visible = sum(min(start + i + 1, L) for i in range(S))
        nbytes = 2 * S * H * D * 2 + 2 * L * Hkv * D * 2 + bt.numel() * 4 + 8
        bound_ms, bound_by = bound(4 * H * D * visible, nbytes)
        r = {"ms": time_ms(torch, fn),
             "device_ms": device_ms(torch, fn, "paged_prefill", floor=bound_ms),
             "plain_ms": time_ms(torch, lambda: ref.paged_prefill_attention_ref(q, *pools, bt, st,
                                                                                ln),
                                 trials=5, per_trial=2),
             "bound_ms": bound_ms, "bound_by": bound_by,
             "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, attn_mask=mask, enable_gqa=True)),
             "gather_sdpa_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                 qt, ref._gather_pages(pools[0], bt).transpose(1, 2),
                 ref._gather_pages(pools[1], bt).transpose(1, 2), attn_mask=mask,
                 enable_gqa=True)),
             "flash_fwd_gathered_ms": time_ms(torch, fwd),
             "flash_fwd_gathered_device_ms": device_ms(torch, fwd, "flash_attention_fwd",
                                                       floor=bound_ms)}
        print(f"paged_prefill S={S} at start {start} (context {L}) H={H} Hkv={Hkv} D={D} page "
              f"{page} bf16 on {card}: {r['ms']:.4f} ms back to back, device "
              f"{fmt_ms(r['device_ms'])} ms (bound {bound_ms:.4f} ms by {bound_by}, "
              f"{per_device_ms(4 * H * D * visible, r['device_ms'], 'TFLOP/s', 1e9)}), plain "
              f"{r['plain_ms']:.4f} ms; flash_attention_fwd over the same rows gathered "
              f"beforehand (q_offset = start) {r['flash_fwd_gathered_ms']:.4f} ms, device "
              f"{fmt_ms(r['flash_fwd_gathered_device_ms'])}; scaled_dot_product_attention over "
              f"the pre-gathered dense cache (causal offset mask, GQA) {r['library_ms']:.4f} ms, "
              f"the page gather and SDPA together {r['gather_sdpa_ms']:.4f} ms")
        return r

    main = recs["512-token chunk at start 512 over shared pages"]
    rec = timed(*main[:4])
    bucket = timed(*recs["64-token bucket, 37 valid, start 1000"][:4])
    return {"name": "paged_prefill", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:258", "launches": 0,
            "max_abs_err": main[4], **rec, "bucket_64": bucket}


def check_paged_kv_write(torch, ref, paged_kv_write, paged_decode, flash_decode, randn, card):
    """Row 11.  The standalone insert against ``paged_kv_write_ref`` at the
    decode shape (B 32, the default pool of 4 097 pages of 16, Hkv 4, D
    128): live slots on distinct pages, idle slots colliding on row 0 of the
    null page.  The written rows must be equal bit for bit; the null page's
    row 0 holds idle slots' data.  Then the insert the decode step runs,
    fused into the paged decode (``check_paged_append``), with the pair and
    the fused launch timed in turns.  Returns its kernel record."""
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
    plain_ms = time_ms(torch, lambda: ref.paged_kv_write_ref(wk, wv, k_new, v_new, pi, ri))
    idx = (pi.long(), ri.long())
    kn, vn = k_new[:, 0], v_new[:, 0]

    def index_put_pair():
        wk.index_put_(idx, kn)
        wv.index_put_(idx, vn)

    lib_ms = time_ms(torch, index_put_pair)
    nbytes = 2 * (2 * B * Hkv * D * 2) + 2 * B * 4       # new rows read, pool rows written
    bound_ms, bound_by = bound(0, nbytes)
    dev_ms = device_ms(torch, fn, "paged_kv_write", floor=bound_ms)
    print(f"paged_kv_write B={B} Hkv={Hkv} D={D} bf16 on {card}: {ms:.4f} ms back to back, device "
          f"{fmt_ms(dev_ms)} ms (bound {bound_ms:.6f} ms by {bound_by}), plain {plain_ms:.4f} ms, "
          f"index_put_ pair {lib_ms:.4f} ms")
    fused = check_paged_append(torch, ref, paged_kv_write, paged_decode, flash_decode, randn,
                               card)
    return {"name": "paged_kv_write", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:340", "launches": 0,
            "max_abs_err": fused.pop("max_abs_err"), "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "fused": fused}


def _append_case(torch, np, rng, randn, B, cap, H, Hkv, D, page, P, lens, idle, masked):
    """A decode step's inputs over a pool of ``P`` pages: slot b live on
    pages of its own at length ``lens[b]`` (its new row at lens[b] - 1),
    the ``idle`` slots at position 0 and the ``masked`` ones at position
    lens[b] - 1, both with their table rows on the null page, as the engine
    leaves them; the addresses from ``paged_decode_addressing``."""
    from repro_torch.models.attention import paged_decode_addressing

    dev = torch.device("cuda")
    live = np.ones(B, bool)
    live[list(idle) + list(masked)] = False
    lens = np.maximum(lens, 1)                 # a decode step's new row: length >= 1
    pos = np.where(np.isin(np.arange(B), idle), 0, lens - 1)
    bt = _paged_layout(torch, np, rng, np.where(live, lens, 0), page, cap // page, P, dev)
    addr = paged_decode_addressing(bt, torch.as_tensor(pos, dtype=torch.int32, device=dev), page)
    return dict(q=randn(B, 1, H, D), k_pool=randn(P, page, Hkv, D), v_pool=randn(P, page, Hkv, D),
                k_new=randn(B, 1, Hkv, D), v_new=randn(B, 1, Hkv, D), bt=bt,
                lengths=addr["lengths"], pi=addr["page_idx"], ri=addr["row"],
                live=torch.as_tensor(live, device=dev), n_live=int((pos + 1)[live].sum()))


def check_paged_append(torch, ref, paged_kv_write, paged_decode, flash_decode, randn, card):
    """The decode step's K/V insert fused into the paged decode
    (``paged_decode`` with ``k_new, v_new, page_idx, row``) against the
    standalone insert followed by ``paged_decode`` (the pair), at Qwen2-7B's
    decode shape over the default pool (pages of 16, check_paged_decode's
    lengths, slot 0 idle, slot 3 masked mid-prefill), at pages of 8 (group
    1) and at pages of 12 (D 64, group 7; lengths 1, the capacity and the
    256-key split edge among them), and at head-TP ranks' shares of the
    heads (Qwen2-7B at model 2 and 4, Llama-3-405B at 8, and at 16 with
    its K/V head inserted from a view of the projection's eight).  Each case: the live rows of the
    output equal to the pair's bit for bit and to flash_decode over the
    updated pools gathered, within 2e-2 of each row's max of the plain
    version; the pools equal to the pair's and the plain version's outside
    the null page; a repeat bit-identical there and on the live rows; the
    idle and masked rows finite.  Then the pair, the fused launch and
    paged_decode alone at the main shape, in turns (the order and back,
    twice).  Returns the fused launch's record."""
    import numpy as np

    rng = np.random.default_rng(12)
    tol = 2e-2   # as check_paged_decode: the plain version rounds P to bf16
    cases = [
        ("qwen2-7b decode shape, page 16", dict(B=32, cap=2048, H=28, Hkv=4, D=128, page=16,
                                                P=4097)),
        ("group 1, page 8", dict(B=8, cap=704, H=8, Hkv=8, D=128, page=8, P=712)),
        ("D=64, group 7, page 12", dict(B=8, cap=720, H=14, Hkv=2, D=64, page=12, P=490)),
        # head-TP ranks' shares of the heads; Llama-3-405B at model 16
        # inserts its one K/V head as a view of the projection's 8
        ("qwen2-7b rank at model=2, group 7", dict(B=32, cap=2048, H=14, Hkv=2, D=128, page=16,
                                                   P=4097)),
        ("qwen2-7b rank at model=4, group 7", dict(B=32, cap=2048, H=7, Hkv=1, D=128, page=16,
                                                   P=4097)),
        ("llama3-405b rank at model=8, group 16", dict(B=32, cap=2048, H=16, Hkv=1, D=128,
                                                       page=16, P=4097)),
        ("llama3-405b rank at model=16, K/V a narrow of 8 heads", dict(
            B=32, cap=2048, H=8, Hkv=1, D=128, page=16, P=4097, narrow_of=8)),
    ]
    main, max_err = None, 0.0
    for label, c in cases:
        B, cap = c["B"], c["cap"]
        if main is None:     # check_paged_decode's main lengths (31 163 live rows)
            lens = np.random.default_rng(1).integers(0, cap + 1, size=B)
            lens[:3] = [0, 1, cap]
        else:
            lens = rng.integers(1, cap + 1, size=B)
            lens[1:6] = [1, cap, lens[3], 256, 257]
        x = _append_case(torch, np, rng, randn, B, cap, c["H"], c["Hkv"], c["D"], c["page"],
                         c["P"], lens, idle=[0], masked=[3])
        if c.get("narrow_of"):     # the rank's K/V head: one head of the projection's
            for n in ("k_new", "v_new"):
                x[n] = randn(B, 1, c["narrow_of"], c["D"]).narrow(2, 5, 1)
        q, bt, lengths, live = x["q"], x["bt"], x["lengths"], x["live"]
        new = dict(k_new=x["k_new"], v_new=x["v_new"], page_idx=x["pi"], row=x["ri"])
        pk, pv = x["k_pool"].clone(), x["v_pool"].clone()
        paged_kv_write(pk, pv, x["k_new"], x["v_new"], x["pi"], x["ri"])
        pair = paged_decode(q, pk, pv, bt, lengths)
        fk, fv = x["k_pool"].clone(), x["v_pool"].clone()
        out = paged_decode(q, fk, fv, bt, lengths, **new)
        torch.cuda.synchronize()
        rk, rv = x["k_pool"].clone(), x["v_pool"].clone()
        again = paged_decode(q, rk, rv, bt, lengths, **new)
        wk, wv = x["k_pool"].clone(), x["v_pool"].clone()
        want = ref.paged_decode_append_ref(q, wk, wv, bt, lengths, x["k_new"], x["v_new"], x["pi"],
                                           x["ri"])
        dense = flash_decode(q, ref._gather_pages(fk, bt), ref._gather_pages(fv, bt), lengths)
        err = row_rel_err(out[live], want[live])
        same = torch.equal(out[live], pair[live])
        pools = all(torch.equal(a[1:], b[1:]) for a, b in ((fk, pk), (fv, pv), (fk, wk), (fv, wv)))
        repeat = (torch.equal(again[live], out[live]) and torch.equal(rk[1:], fk[1:])
                  and torch.equal(rv[1:], fv[1:]))
        flash = torch.equal(dense[live], out[live])
        finite = bool(out.isfinite().all())
        print(f"paged_decode with the fused insert, {label} (B={B}, capacity {cap}, H={c['H']}, "
              f"Hkv={c['Hkv']}, D={c['D']}, {c['P']} pages; slot 0 idle, slot 3 masked) bf16: live "
              f"rows = the pair (paged_kv_write, then paged_decode) bit for bit {same}, = "
              f"flash_decode over the updated pools gathered {flash}; rel err {err:.3g} (tol {tol} "
              f"of each row's max|plain|); pools = the pair's and the plain version's outside "
              f"the null page {pools}; repeat bit-identical {repeat}; every row finite {finite}")
        check(same and flash and err <= tol and pools and repeat and finite,
              f"paged_decode with the fused insert, {label}")
        max_err = max(max_err, (fk[1:].float() - wk[1:].float()).abs().max().item(),
                      (fv[1:].float() - wv[1:].float()).abs().max().item())
        if main is None:
            main = (x, new, fk, fv)
    x, new, tk, tv = main
    q, bt, lengths = x["q"], x["bt"], x["lengths"]
    B, _, H, D = q.shape
    Hkv = tk.shape[2]
    calls = {
        "pair": lambda: (paged_kv_write(tk, tv, x["k_new"], x["v_new"], x["pi"], x["ri"]),
                         paged_decode(q, tk, tv, bt, lengths)),
        "fused": lambda: paged_decode(q, tk, tv, bt, lengths, **new),
        "alone": lambda: paged_decode(q, tk, tv, bt, lengths),
    }
    names = {"pair": ("paged_kv_write", "paged_decode"), "fused": ("paged_decode",),
             "alone": ("paged_decode",)}
    runs = {n: [] for n in calls}
    for n in ["pair", "fused", "alone", "alone", "fused", "pair"] * 2:
        runs[n].append((time_ms(torch, calls[n]), device_ms(torch, calls[n], *names[n])))
    mean = {n: (statistics.mean(t for t, _ in r),
                statistics.mean(d for _, d in r) if all(d for _, d in r) else None)
            for n, r in runs.items()}
    diffs = ([f[1] - a[1] for f, a in zip(runs["fused"], runs["alone"])]
             if mean["fused"][1] and mean["alone"][1] else [])
    print(f"in turns at qwen2-7b's decode shape ({x['n_live']} live rows) on {card}: pair "
          f"{mean['pair'][0]:.4f} ms back to back, device {fmt_ms(mean['pair'][1])} ms; fused "
          f"{mean['fused'][0]:.4f}, device {fmt_ms(mean['fused'][1])}; paged_decode alone "
          f"{mean['alone'][0]:.4f}, device {fmt_ms(mean['alone'][1])}; the insert inside the "
          f"fused launch (fused - alone, device, each turn) "
          f"{[round(d, 5) for d in diffs] or 'not measured'}; readings {runs}")
    return {"source": "src/repro_torch/kernels/csrc/paged_attention.cu", "launches": 0,
            "max_abs_err": max_err, "pair_ms": mean["pair"][0], "pair_device_ms": mean["pair"][1],
            "fused_ms": mean["fused"][0], "fused_device_ms": mean["fused"][1],
            "alone_ms": mean["alone"][0], "alone_device_ms": mean["alone"][1],
            "insert_device_ms": statistics.mean(diffs) if diffs else None,
            "insert_device_ms_turns": diffs, "runs": runs}


def _router_sizes(np, rng, tokens, E, empty=(), cap=None):
    """Group sizes from a seeded skewed router draw of ``tokens`` top-1
    choices over E experts: the experts in ``empty`` never drawn, and each
    count cut to ``cap`` (the capacity) when given."""
    p = np.exp(1.5 * rng.standard_normal(E))
    p[list(empty)] = 0.0
    counts = np.bincount(rng.choice(E, size=tokens, p=p / p.sum()), minlength=E)
    return np.minimum(counts, cap) if cap is not None else counts


def check_gmm(torch, ref, gmm, card):
    """Row 12 against ``grouped_matmul_ref`` in both of the forward's modes
    (decode at 128 rows or fewer, row tiles above): Llama-4-Scout's decode
    and prefill shapes, the w_out shape, Maverick's 128 experts, all groups
    empty, one group holding every row, M = 50, Scout's training forward
    (M 2048, capacity 160), groups that begin and end inside a 256-row tile
    or a 32-row chunk with the next group's rows of x at 1e30, groups of one
    row, and K 200 / N 136 for the tensor maps' zero fill; rows past the
    sizes' sum must be exactly 0, and a repeat at decode and at prefill
    bit-identical.  Times the four Scout shapes, decode w_in's the record's.
    Returns its kernel record."""
    import numpy as np

    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    tol = 2e-2      # of each row's max|ref|: fp32 sums of the same bf16 products in another order
    d, f = 5120, 8192

    def bf16(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev) * scale).to(torch.bfloat16)

    scout_w = {"w_in": bf16(16, d, f, scale=d ** -0.5), "w_out": bf16(16, f, d, scale=f ** -0.5)}
    # (label, M, weights or (E, K, N), sizes, groups whose following rows of x are at 1e30)
    cases = [
        ("scout decode, w_in", 32, "w_in", _router_sizes(np, rng, 32, 16, empty=(3,)), ()),
        ("scout prefill, w_in, capacity 80", 1024, "w_in", _router_sizes(np, rng, 1024, 16, cap=80),
         ()),
        ("scout decode, w_out", 32, "w_out", _router_sizes(np, rng, 32, 16, empty=(0, 9)), ()),
        ("all groups empty", 32, "w_in", np.zeros(16, np.int64), ()),
        ("one group holds every row", 32, "w_out", np.eye(16, dtype=np.int64)[7] * 32, ()),
        ("M = 50", 50, "w_in", _router_sizes(np, rng, 46, 16), ()),
        ("scout training, w_in, capacity 160", 2048, "w_in", gmm_train_sizes(np)["w_in"], ()),
        ("groups end inside a 256-row tile, the next rows of x at 1e30", 512, (8, 256, 384),
         [37, 90, 1, 100, 0, 85, 70, 50], (0, 1, 3, 6)),
        ("groups end inside a 32-row chunk, the next rows of x at 1e30", 120, (8, 256, 384),
         [5, 40, 1, 0, 33, 20, 7, 9], (0, 1, 4, 5)),
        ("groups of one row, decode mode", 128, (4, 256, 384), [1, 0, 126, 1], ()),
        ("groups of one row, row tiles", 300, (5, 256, 384), [1, 0, 1, 297, 1], ()),
        ("K 200, N 136, decode mode", 77, (5, 200, 136), [9, 0, 31, 1, 30], ()),
        ("K 200, N 136, row tiles", 333, (5, 200, 136), [33, 0, 120, 1, 150], ()),
    ]
    inputs = {}
    for label, M, wname, sizes, large in cases:
        sizes = np.asarray(sizes, np.int64)
        w = scout_w[wname] if isinstance(wname, str) else bf16(*wname, scale=wname[1] ** -0.5)
        E = w.shape[0]
        x = torch.randn(M, w.shape[1], device=dev).to(torch.bfloat16)
        ends, total = np.cumsum(sizes), int(sizes.sum())
        for g in large:      # the rows after group g's (the next group's, or the tail) at 1e30
            x[ends[g]:ends[g + 1] if g + 1 < E else M] = 1e30
        if large:
            x[total:] = 1e30
        gs = torch.as_tensor(sizes, dtype=torch.int32, device=dev)
        out = gmm(x, w, gs)
        again = gmm(x, w, gs)
        torch.cuda.synchronize()
        want = ref.grouped_matmul_ref(x, w, gs)
        err = row_rel_err(out[:total], want[:total]) if total else 0.0
        tail0 = bool((out[total:] == 0).all())
        same = torch.equal(out, again)
        mode = "decode mode" if M <= 128 else "row tiles"
        print(f"gmm {label} (M={M}, {mode}, K={w.shape[1]}, N={w.shape[2]}, E={E}, "
              f"{int((sizes > 0).sum())} live groups, {total} rows in groups): rel err {err:.3g} "
              f"(tol {tol} of each row's max|ref|), the {M - total} rows past the groups exactly 0: "
              f"{tail0}, a repeat bit-identical: {same}")
        check(err <= tol and tail0 and same and bool(out.isfinite().all()), f"gmm {label}")
        if label.startswith("scout"):
            inputs[label] = (x, w, gs, sizes, (out.float() - want.float()).abs().max().item())
        del out, again, want
    # Maverick: 128 experts (10.7 GB of w_in), most of them empty at decode
    w128 = bf16(128, d, f, scale=d ** -0.5)
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
        # this run's data: each live group's weight once, x and y once
        nbytes = live * K * N * 2 + M * K * 2 + M * N * 2 + E * 4
        bound_ms, bound_by = bound(2 * int(sizes.sum()) * K * N, nbytes)
        ms = time_ms(torch, lambda: gmm(x, w, gs), trials=10)
        dev_ms = device_ms(torch, lambda: gmm(x, w, gs), "gmm_fwd", n=10, floor=bound_ms)
        plain_ms = time_ms(torch, lambda: ref.grouped_matmul_ref(x, w, gs), trials=3, per_trial=2,
                           warmup=1)
        ends = torch.cumsum(gs, 0, dtype=torch.int32)
        lib_ms, lib_name = _grouped_mm_lib(torch, lambda: torch._grouped_mm(x, w, offs=ends))
        print(f"gmm {label} (M={M}, K={K}, N={N}, {live} of {E} groups live) bf16 on {card}: "
              f"{ms:.4f} ms back to back, device {fmt_ms(dev_ms)} ms (bound {bound_ms:.4f} ms by "
              f"{bound_by}, {per_device_ms(nbytes, dev_ms, 'GB/s', 1e6)}), plain {plain_ms:.4f} ms, "
              f"{lib_name}" + (f" {lib_ms:.4f} ms" if lib_ms is not None else ""))
        return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": lib_ms}

    shapes = {label: timed(label) for label in inputs}
    main = shapes.pop("scout decode, w_in")
    return {"name": "gmm", "route": "cuda", "source": "src/repro_torch/kernels/csrc/grouped_matmul.cu",
            "replaces": "src/repro/kernels/grouped_matmul.py:198", "launches": 0,
            "max_abs_err": inputs["scout decode, w_in"][4], **main, "shapes": shapes}


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


def gmm_train_sizes(np):
    """The seeded group sizes of ``check_gmm_dw``'s random cases, in the order
    it draws them: a Dirichlet-uneven split of 512 rows over 8 groups,
    Maverick's 128 experts at capacity 16 (1 024 tokens), and Scout's w_in
    and w_out micro-batches of 2 048 tokens over 16 experts at capacity
    160.  ``gmm_variants.py`` times the same Scout sizes."""
    rng = np.random.default_rng(3)
    return {"dirichlet": rng.multinomial(512, rng.dirichlet(np.ones(8))),
            "maverick": _router_sizes(np, rng, 1024, 128, cap=16),
            "w_in": _router_sizes(np, rng, 2048, 16, cap=160),
            "w_out": _router_sizes(np, rng, 2048, 16, cap=160)}


def check_gmm_dw(torch, ref, gmm, gmm_dw, card):
    """Row 13 (``gmm_dw``) against ``grouped_matmul_dw_ref`` and row 12's
    transposed mode (the backward's dx) against ``grouped_matmul_ref`` on
    the transposed weights, in the ragged cases of the reference's MoE tests
    (even, Dirichlet-uneven, all empty, one group takes all, a dropped tail
    with large finite values in its rows of x and dy, interior empty
    groups), M = 77 (no multiple of a tile), the schedules' edges (groups
    ending inside a 64-row slice with the next groups' rows of x at 1e30,
    groups of one row, a group of 600 rows, K 200 and N 136 for the tensor
    maps' zero fill), Maverick's 128 experts at a small K and N, and
    Scout's w_in and w_out at M = 2048 (a 2 x 1024 micro-batch, capacity
    160).  dW: fp32 within 1e-3 of each group's max|ref| (bf16 products are
    exact in fp32; only the order of the sums differs), bf16 within 1e-3 +
    2^-8, empty groups exactly 0, a repeat bit-identical; dx: 2e-2 of each
    row's max|ref|, rows past the groups exactly 0, a repeat bit-identical.
    Times both modes at both Scout shapes.  Returns the gmm_dw record and
    the record of gmm's transposed mode (w_in's numbers, w_out's under
    "w_out")."""
    import numpy as np

    dev = torch.device("cuda")
    dw_tol, dx_tol = 1e-3, 2e-2
    drawn = gmm_train_sizes(np)

    def bf16(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev) * scale).to(torch.bfloat16)

    # (label, M, K, N, sizes, groups whose rows of x are scaled by 1e30)
    cases = [
        ("even", 512, 256, 384, [64] * 8, ()),
        ("Dirichlet-uneven", 512, 256, 384, drawn["dirichlet"], ()),
        ("all groups empty", 512, 256, 384, [0] * 8, ()),
        ("one group takes all", 512, 256, 384, [0, 0, 0, 512, 0, 0, 0, 0], ()),
        ("dropped tail, large tail rows", 512, 256, 384, [40, 0, 77, 13, 0, 90, 30, 50], ()),
        ("interior empty groups", 512, 256, 384, [0, 128, 0, 0, 100, 0, 200, 84], ()),
        ("M = 77", 77, 256, 384, [9, 0, 31, 0, 5, 20, 12, 0], ()),
        ("group ends inside a slice, the next group's x at 1e30", 512, 256, 384,
         [37, 90, 1, 100, 0, 85, 70, 50], (1, 3, 6)),
        ("groups of one row", 128, 256, 384, [1, 0, 126, 1], ()),
        ("a group of 600 rows", 1024, 256, 384, [100, 600, 0, 200, 60], ()),
        ("K 200, N 136", 333, 200, 136, [33, 0, 120, 1, 150], ()),
        ("maverick, 128 experts", 1024, 128, 256, drawn["maverick"], ()),
        ("scout w_in, capacity 160", 2048, 5120, 8192, drawn["w_in"], ()),
        ("scout w_out, capacity 160", 2048, 8192, 5120, drawn["w_out"], ()),
    ]
    dw_err0, dx_err0, timing = 0.0, 0.0, {}
    for label, M, K, N, sizes, large in cases:
        sizes = np.asarray(sizes, np.int64)
        E, total = len(sizes), int(sizes.sum())
        x = bf16(M, K)
        dy = bf16(M, N)
        x[total:], dy[total:] = 1e30, -1e30          # rows past the groups: never summed
        ends = np.cumsum(sizes)
        for g in large:                              # finite, and summed only into their own dW
            x[ends[g] - sizes[g]:ends[g]] *= 1e30
        w = bf16(E, K, N, scale=K ** -0.5)
        gs = torch.as_tensor(sizes, dtype=torch.int32, device=dev)
        dw = gmm_dw(x, dy, gs)
        again = gmm_dw(x, dy, gs)
        dw16 = gmm_dw(x, dy, gs, out_dtype=torch.bfloat16)
        dx = gmm(dy, w, gs, transpose_w=True)
        dx_again = gmm(dy, w, gs, transpose_w=True)
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
        same_dx = torch.equal(dx, dx_again)
        print(f"gmm_dw {label} (M={M}, K={K}, N={N}, E={E}, {len(live)} live groups, {total} rows "
              f"in groups): rel err {err:.3g} (tol {dw_tol} of each group's max|ref|), bf16 output "
              f"{err16:.3g} (tol {dw_tol} + 2^-8), empty groups exactly 0: {empty0}, a repeat "
              f"bit-identical: {same}; dx (gmm, transposed w) rel err {err_dx:.3g} (tol {dx_tol} "
              f"of each row's max|ref|), the {M - total} rows past the groups exactly 0: {tail0}, "
              f"a repeat bit-identical: {same_dx}")
        check(err <= dw_tol and err16 <= dw_tol + 2 ** -8 and empty0 and same
              and bool(dw.isfinite().all()), f"gmm_dw {label}")
        check(err_dx <= dx_tol and tail0 and same_dx and bool(dx.isfinite().all()),
              f"gmm transposed {label}")
        if label.startswith("scout"):
            shape = label.split()[1].rstrip(",")
            if shape == "w_in":
                dw_err0 = (dw16.float() - want).abs().max().item()
                dx_err0 = (dx.float() - want_dx.float()).abs().max().item()
            timing[shape] = (x, dy, w, gs, sizes)
        del x, dy, w, dw, again, dw16, dx, dx_again, want, want_dx

    recs = {}
    for shape, (x, dy, w, gs, sizes) in timing.items():
        M, K, N, E = x.shape[0], x.shape[1], dy.shape[1], len(sizes)
        total, live = int(sizes.sum()), int((sizes > 0).sum())
        ends = torch.cumsum(gs, 0, dtype=torch.int32)
        flops = 2 * total * K * N
        # the main path writes dW in the weights' dtype, bf16
        ms = time_ms(torch, lambda: gmm_dw(x, dy, gs, out_dtype=torch.bfloat16), trials=10)
        ms32 = time_ms(torch, lambda: gmm_dw(x, dy, gs), trials=10)
        plain_ms = time_ms(torch, lambda: ref.grouped_matmul_dw_ref(x, dy, gs), trials=3,
                           per_trial=1, warmup=1)
        lib_ms, lib_name = _grouped_mm_lib(torch, lambda: torch._grouped_mm(x.t(), dy, offs=ends))
        nbytes = total * (K + N) * 2 + E * K * N * 2 + E * 4
        bound_ms, bound_by = bound(flops, nbytes)
        bound32, by32 = bound(flops, nbytes + E * K * N * 2)
        dev_ms = device_ms(torch, lambda: gmm_dw(x, dy, gs, out_dtype=torch.bfloat16),
                           "gmm_dw_kernel", n=10, floor=bound_ms)
        dev32 = device_ms(torch, lambda: gmm_dw(x, dy, gs), "gmm_dw_kernel", n=10, floor=bound32)
        print(f"gmm_dw scout {shape} training shape (M={M}, K={K}, N={N}, {live} of {E} groups "
              f"live, {total} rows) on {card}: bf16 dW {ms:.4f} ms back to back, device "
              f"{fmt_ms(dev_ms)} ms (bound {bound_ms:.4f} ms by {bound_by}, "
              f"{per_device_ms(flops, dev_ms, 'TFLOP/s', 1e9)}, "
              f"{per_device_ms(nbytes, dev_ms, 'GB/s', 1e6)}); fp32 dW {ms32:.4f} ms, device "
              f"{fmt_ms(dev32)} ms (bound {bound32:.4f} ms by {by32}, "
              f"{per_device_ms(nbytes + E * K * N * 2, dev32, 'GB/s', 1e6)}); plain "
              f"{plain_ms:.4f} ms; {lib_name}" + (f" {lib_ms:.4f} ms" if lib_ms is not None else ""))
        recs[("gmm_dw", shape)] = {
            "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms, "fp32_ms": ms32, "fp32_device_ms": dev32,
            "fp32_bound_ms": bound32}
        dx_ms = time_ms(torch, lambda: gmm(dy, w, gs, transpose_w=True), trials=10)
        dx_plain = time_ms(torch, lambda: ref.grouped_matmul_ref(dy, w.transpose(1, 2), gs),
                           trials=3, per_trial=1, warmup=1)
        wt = w.transpose(1, 2)
        dx_lib, dx_lib_name = _grouped_mm_lib(torch, lambda: torch._grouped_mm(dy, wt, offs=ends))
        dx_bytes = live * K * N * 2 + M * N * 2 + M * K * 2 + E * 4
        dx_bound, dx_by = bound(flops, dx_bytes)
        dx_dev = device_ms(torch, lambda: gmm(dy, w, gs, transpose_w=True), "gmm_dx_kernel", n=10,
                           floor=dx_bound)
        print(f"gmm transposed (dx = dy @ w[g]^T) scout {shape} training shape (M={M}, depth {N}, "
              f"out {K}) on {card}: {dx_ms:.4f} ms back to back, device {fmt_ms(dx_dev)} ms "
              f"(bound {dx_bound:.4f} ms by {dx_by}, {per_device_ms(flops, dx_dev, 'TFLOP/s', 1e9)}, "
              f"{per_device_ms(dx_bytes, dx_dev, 'GB/s', 1e6)}), plain {dx_plain:.4f} ms, "
              f"{dx_lib_name}" + (f" {dx_lib:.4f} ms" if dx_lib is not None else ""))
        recs[("dx", shape)] = {"ms": dx_ms, "device_ms": dx_dev, "plain_ms": dx_plain,
                               "bound_ms": dx_bound, "bound_by": dx_by, "library_ms": dx_lib}
        del x, dy, w, wt
    timing.clear()
    src = "src/repro_torch/kernels/csrc/grouped_matmul.cu"
    dw_rec = {"name": "gmm_dw", "route": "cuda", "source": src,
              "replaces": "src/repro/kernels/grouped_matmul.py:280", "launches": 0,
              "max_abs_err": dw_err0, **recs[("gmm_dw", "w_in")],
              "w_out": recs[("gmm_dw", "w_out")]}
    dx_rec = {"name": "gmm (transposed, dx)", "route": "cuda", "source": src,
              "replaces": "src/repro/kernels/grouped_matmul.py:198", "launches": 0,
              "max_abs_err": dx_err0, **recs[("dx", "w_in")], "w_out": recs[("dx", "w_out")]}
    return dw_rec, dx_rec


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
    its read-out y = h·C (2·P·N), dt·x and D·x (3·P).  At fp32's rate this
    was the kernel's bound while its products ran on fp32 FMA; it is still
    printed beside the bound, labelled, so that the kernel table's rows
    stay comparable."""
    return (5 * P * N + 3 * P) * B * S * H


def ssd_chunked_flops(B, S, H, P, G, N, L=64):
    """FLOPs of the products of the chunked dual form at the kernel's chunk
    of L rows, for this S: per chunk of r rows the causal half of C·Bᵀ once
    per group (r(r+1)/2·N), and per head the causal half of att·x
    (r(r+1)/2·P), C·hᵀ and the state update (r·P·N each), two FLOPs a
    product, and the state's decay (P·N)."""
    total = 0
    for c0 in range(0, S, L):
        r = min(L, S - c0)
        tri = r * (r + 1) // 2
        total += 2 * (G * tri * N + H * (tri * P + 2 * r * P * N)) + H * P * N
    return B * total


def ssd_bound(B, S, H, P, G, N):
    """(the scan's least time in ms, what bounds it, the fp32-recurrence
    figure): the larger of the bytes of x, y, dt, B, C and the state over
    the card's memory rate and the chunked form's products at the bf16
    tensor-core rate; beside it the sequential recurrence at fp32's rate
    (the bound before the products moved to the tensor cores)."""
    nbytes = 2 * B * S * H * P * 2 + B * H * P * N * 4 + B * S * H * 4 + 2 * B * S * G * N * 2
    ms, by = bound(ssd_chunked_flops(B, S, H, P, G, N), nbytes)
    return ms, by, bound(ssd_flops(B, S, H, P, N), nbytes, PEAK_FP32_FLOPS)[0], nbytes


def check_ssd_scan(torch, ref, ssd_scan, card):
    """Row 14 against ``ssd_scan_ref`` (the kernel's math in fp32, at the
    configs' chunk of 128) at Mamba2-2.7B's prefill shape at S = 1024 and
    at a tail length, batch 4, two groups, S shorter than a chunk, and
    large steps (dt·|A| up to ~50 a row, so exp(cum_t − cum_s) overflows
    above the diagonal and must be selected away), and N = 12 (C's rows
    start off a 16-byte boundary, so the kernel copies them element by
    element, and N pads to 16).  y within 2 bf16 steps
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
        ("N=12: C's rows not 16-byte aligned, columns past N", (1, 100, 8, 32, 1, 12), -4.0),
    ]
    inputs = {}
    for label, (B, S, H, P, G, N), shift in cases:
        args = _ssd_case(torch, g, B, S, H, P, G, N, shift)
        y, state = ssd_scan(*args)
        torch.cuda.synchronize()
        want_y, want_state = ref.ssd_scan_ref(*args, chunk=128)
        y_steps = bf16_steps(torch, y, want_y, 3)
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
    plain_ms = time_ms(torch, lambda: ref.ssd_scan_ref(*args, chunk=128), trials=3, per_trial=2,
                       warmup=1)
    G = Bm.shape[2]
    flops = ssd_chunked_flops(B, S, H, P, G, N)
    bound_ms, bound_by, fp32_ms, nbytes = ssd_bound(B, S, H, P, G, N)
    dev_ms = device_ms(torch, lambda: ssd_scan(*args), "ssd_scan_kernel", n=10, floor=bound_ms)
    print(f"ssd_scan mamba2-2.7b prefill (B={B}, S={S}, H={H}, P={P}, N={N}) bf16 on {card}: "
          f"{ms:.4f} ms back to back, device {fmt_ms(dev_ms)} ms (bound {bound_ms:.4f} ms by "
          f"{bound_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP of the chunked form's "
          f"products at the bf16 rate; {per_device_ms(nbytes, dev_ms, 'GB/s', 1e6)}; the "
          f"sequential recurrence at fp32's rate, the bound while the products ran on fp32 "
          f"FMA: {fp32_ms:.4f} ms), plain "
          f"{plain_ms:.4f} ms, library: none (no single PyTorch call computes the scan)")
    # the admission lengths the Mamba2 path sees (prompts of 64-1024 tokens,
    # mean ~544): device time and bound at each
    by_s = {}
    for s_len in (64, 256, 544, 1024):
        a = _ssd_case(torch, g, 1, s_len, H, P, 1, N, -4.0)
        b_ms, _, f_ms, _ = ssd_bound(1, s_len, H, P, 1, N)
        by_s[s_len] = (device_ms(torch, lambda: ssd_scan(*a), "ssd_scan_kernel", n=10, floor=b_ms),
                       b_ms, f_ms)
    print(f"ssd_scan at the admission lengths (B=1, H={H}, P={P}, N={N}) on {card}: " + ", ".join(
        f"S={k} device {fmt_ms(v[0])} ms (bound {v[1]:.4f}; fp32 recurrence {v[2]:.4f})"
        for k, v in by_s.items()))
    return {"name": "ssd_scan", "route": "cuda", "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:136", "launches": 0, "max_abs_err": max_err,
            "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "fp32_recurrence_ms": fp32_ms,
            "device_ms_by_S": {str(k): v[0] for k, v in by_s.items()},
            "bound_ms_by_S": {str(k): v[1] for k, v in by_s.items()}}


# the backward's kernels, by the substrings of their names (each holds
# "ssd_bwd", which ``kernel_groups`` reads as the SSD backward)
SSD_BWD_KERNELS = ("ssd_bwd_state", "ssd_bwd_chunk", "ssd_bwd_sum")


def ssd_bwd_flops(B, S, H, P, G, N, L=64):
    """FLOPs of the chunked backward's products at L rows, for this S: per
    chunk of r rows C·Bᵀ once a group (its causal half), and per head dy·xᵀ
    and M·dy (causal halves over P), dS·C and dS·B (over N), and the four
    (r, P, N) products: dh_out·B (dx), dh_outᵀ·x (dB), h_inᵀ·dy (dC) and
    the carried state's exp(cum)·dy·Cᵀ; two FLOPs a product."""
    total = 0
    for c0 in range(0, S, L):
        r = min(L, S - c0)
        tri = r * (r + 1) // 2
        total += 2 * (G * tri * N + H * (2 * tri * P + 2 * tri * N + 4 * r * P * N))
    return B * total


def ssd_bwd_bound(B, S, H, P, G, N, dstate=False):
    """(least time in ms, what bounds it, the fp32-rate figure, bytes) of
    the backward: each input read once (x, dt, B, C, dy, the chunk states,
    dstate when given, A, D) and each output written once (dx, ddt, dB, dC,
    dA, dD), over the memory rate, against the products at the bf16
    tensor-core rate (x, B, C and dy are bf16); beside it the products at
    fp32's rate, the rate of the kernel's FMA."""
    nc = -(-S // 64)
    io = 2 * (2 * B * S * H * P + B * S * H * 4 + 2 * B * S * G * N * 2 + 2 * H * 4)
    nbytes = io + B * S * H * P * 2 + B * nc * H * P * N * 4 + (B * H * P * N * 4 if dstate else 0)
    flops = ssd_bwd_flops(B, S, H, P, G, N)
    ms, by = bound(flops, nbytes)
    return ms, by, bound(flops, nbytes, PEAK_FP32_FLOPS)[0], nbytes


def check_ssd_scan_bwd(torch, ref, ssd_scan, ssd_scan_bwd, card):
    """The SSD backward (the port's own kernel) against ``ssd_scan_bwd_ref``
    in fp32 on the same bf16 inputs (x, B and C strided views of one
    activation, as ``ssm_apply`` makes them), each given its own forward's
    chunk states, at Mamba2-2.7B's training shape (2 x 1024) and at 1 x
    1024, a tail (S =
    1000), a short sequence (S = 45), batch 2 with G = 2, reduced Jamba's
    (P 32, N 16), large steps (no NaN), N = 20 (B's and C's rows off a
    16-byte boundary: element copies, N padded to 32), a prime number of
    heads a group (H 7, G 1, at a size where the kernel's run takes all
    seven) and P = 96 (slices of 32 rows of P, dx's second pass), with and
    without the final state's gradient: dx, dB and dC within 2 bf16 steps
    of each row's max|plain|; ddt, dA and dD within 1e-3 of their
    max|plain|; the chunk states within 1e-4 of each head's.  The
    forward's y and final state are the same bits with and without the
    chunk states' store, and a repeated backward is bit-identical.  Times
    the Mamba2 training shape (2 x 1024).  Returns its record."""
    from repro_torch.kernels.ssd_scan import _scan, heads_a_run

    g = torch.Generator(device="cuda").manual_seed(27)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [
        ("mamba2-2.7b training 2x1024", (2, 1024, 80, 64, 1, 128), -4.0, False),
        ("mamba2-2.7b S=1024", (1, 1024, 80, 64, 1, 128), -4.0, False),
        ("mamba2-2.7b, tail S=1000, final-state gradient", (1, 1000, 80, 64, 1, 128), -4.0, True),
        ("S=45 < chunk, final-state gradient", (1, 45, 80, 64, 1, 128), -4.0, True),
        ("batch 2, G=2", (2, 200, 8, 64, 2, 128), -4.0, False),
        ("jamba reduced shape", (2, 77, 16, 32, 1, 16), -4.0, True),
        ("large steps", (1, 256, 8, 64, 1, 128), 1.5, True),
        ("N=20: B's and C's rows not 16-byte aligned", (1, 300, 8, 64, 1, 20), -4.0, True),
        ("H=7, G=1: a prime number of heads a group", (2, 32 * sms, 7, 64, 1, 128), -4.0, True),
        ("P=96: slices of 32 rows of P", (1, 200, 4, 96, 1, 64), -4.0, True),
    ]
    names = ("dx", "ddt", "dA", "dB", "dC", "dD")
    keep = {}
    for label, (B, S, H, P, G, N), shift, with_ds in cases:
        args = _ssd_case(torch, g, B, S, H, P, G, N, shift)
        dy = torch.randn(B, S, H, P, generator=g, device="cuda").to(torch.bfloat16)
        ds = torch.randn(B, H, P, N, generator=g, device="cuda") if with_ds else None
        y0, h0 = _scan(*args, 64, states=False)
        y, h, states = _scan(*args, 64, states=True)
        got = ssd_scan_bwd(*args, states, dy, ds)
        torch.cuda.synchronize()
        same_fwd = torch.equal(y, y0) and torch.equal(h, h0)
        f32 = [a.float() for a in args]
        _, _, want_states = ref.ssd_scan_ref(*f32, chunk=64, states=True)
        want = ref.ssd_scan_bwd_ref(*f32, want_states, dy.float(), ds, chunk=64)
        st_err = row_rel_err(states, want_states, dims=3)
        steps = {n: bf16_steps(torch, got[i], want[i], 3) for i, n in ((0, "dx"), (3, "dB"),
                                                                        (4, "dC"))}
        errs = {n: rel_err(got[i], want[i]) for i, n in ((1, "ddt"), (2, "dA"), (5, "dD"))}
        finite = all(bool(t.float().isfinite().all()) for t in got)
        K = heads_a_run(B, -(-S // 64), H, G, sms)
        print(f"ssd_scan_bwd {label} (B={B}, S={S}, H={H}, P={P}, G={G}, N={N}; runs of {K} "
              f"heads): dx, dB, dC "
              f"within {', '.join(f'{v:.3g}' for v in steps.values())} bf16 steps of each row's "
              f"max|plain| (tol 2); ddt, dA, dD rel err "
              f"{', '.join(f'{v:.3g}' for v in errs.values())} (tol 1e-3 of max|plain|); chunk "
              f"states {st_err:.3g} (tol 1e-4 of each head's max); forward bits with the states' "
              f"store unchanged {same_fwd}; finite {finite}")
        check(max(steps.values()) <= 2 and max(errs.values()) <= 1e-3 and st_err <= 1e-4
              and finite and same_fwd, f"ssd_scan_bwd {label}")
        keep[label] = (args, states, dy, ds, max((got[i].float() - want[i]).abs().max().item()
                                                 for i in range(6)))
    args, states, dy, ds, max_err = keep["mamba2-2.7b training 2x1024"]
    first = ssd_scan_bwd(*args, states, dy, ds)
    again = ssd_scan_bwd(*args, states, dy, ds)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    print(f"ssd_scan_bwd repeated at 2x1024: bit-identical {same}")
    check(same, "a repeated ssd_scan_bwd differs")
    x, dt, A, Bm, Cm, D = args
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    ms = time_ms(torch, lambda: ssd_scan_bwd(*args, states, dy, ds), trials=10)
    plain_ms = time_ms(torch, lambda: ref.ssd_scan_bwd_ref(*args, states, dy, ds, chunk=64),
                       trials=3, per_trial=2, warmup=1)
    bound_ms, bound_by, fp32_ms, nbytes = ssd_bwd_bound(B, S, H, P, G, N)
    by_kernel = device_ms_by_kernel(torch, lambda: ssd_scan_bwd(*args, states, dy, ds),
                                    SSD_BWD_KERNELS, n=10)
    dev_ms = sum(by_kernel.values()) or None
    fwd_ms = device_ms(torch, lambda: _scan(*args, 64, states=False), "ssd_scan_kernel", n=10)
    fwd_st_ms = device_ms(torch, lambda: _scan(*args, 64, states=True), "ssd_scan_kernel", n=10)
    flops = ssd_bwd_flops(B, S, H, P, G, N)
    print(f"ssd_scan_bwd mamba2-2.7b training (B={B}, S={S}, H={H}, P={P}, N={N}; runs of "
          f"{heads_a_run(B, -(-S // 64), H, G, sms)} heads) on {card}: "
          f"{ms:.4f} ms back to back, device {fmt_ms(dev_ms)} ms (" + ", ".join(
              f"{k} {v:.4f}" for k, v in by_kernel.items()) + f"; bound {bound_ms:.4f} ms by "
          f"{bound_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP of the chunked backward's "
          f"products at the bf16 rate, {fp32_ms:.4f} ms at fp32's), plain {plain_ms:.4f} ms, "
          f"library: none (no single PyTorch call computes the scan's gradient); the forward "
          f"device {fmt_ms(fwd_ms)} ms, with the chunk states' store {fmt_ms(fwd_st_ms)} ms")
    return {"name": "ssd_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu", "replaces": None,
            "own": "the port's own kernel: the reference's TPU kernel has no backward and its "
                   "gradient is XLA autodiff of _ssd_chunked_xla (src/repro/kernels/ops.py:697)",
            "launches": 0, "max_abs_err": max_err, "ms": ms, "device_ms": dev_ms,
            "device_ms_by_kernel": by_kernel, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "fp32_rate_ms": fp32_ms,
            "forward_device_ms": fwd_ms, "forward_with_states_device_ms": fwd_st_ms}


def generation_load(np, vocab: int, n: int, max_new: int, seed: int = 0, lo: int = 64,
                    hi: int = 1024):
    """The generation phases' load: ``n`` prompts of ``lo``-``hi`` (64-1024)
    random ids below ``vocab`` drawn from ``seed``, and their sampling
    parameters (even ones greedy, odd ones sampled with a seed of their own
    and log-probabilities) -> (lengths, prompts, params)."""
    from repro_torch.serving.sampling import SamplingParams

    rng = np.random.default_rng(seed)
    lengths = rng.integers(lo, hi + 1, size=n)
    prompts = [rng.integers(0, vocab, size=int(L)).tolist() for L in lengths]
    params = [SamplingParams(max_new=max_new) if i % 2 == 0 else
              SamplingParams(temperature=0.8, top_k=50, top_p=0.95, seed=i, max_new=max_new,
                             logprobs=True) for i in range(n)]
    return lengths, prompts, params


def generate_phase(torch, counters, card):
    """Slice 4a: Qwen2-7B generation at full width and depth through
    ``LLM.generate`` over the dense KV cache.  Returns the launch counts of
    the first generate call (the main path's run) and the model, which the
    paged phase serves next."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, build_model
    from repro_torch.serving.api import LLM
    from repro_torch.serving.engine import Request

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
    slots, max_len, n, max_new = 32, 2048, 64, 32
    lengths, prompts, params = generation_load(np, cfg.vocab_size, n, max_new)
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
    return launches, model


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


def compare_logits(torch, got, want, label, expect, margin=1.0):
    """Cosine >= 0.999 at every slot-step, and the same top-1 wherever the
    reference side's top-2 gap exceeds ``margin`` times that slot-step's
    max |dlogit|.  Only a gap above twice it rules a flip out: each of
    the two logits may move by max |dlogit| toward the other, and bf16
    logits then tie, which the first-index argmax breaks by position (the
    slice-7 phases pass 2)."""
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    dmax = (got - want).abs().amax(dim=-1)
    top2 = want.topk(2, dim=-1)
    gap = top2.values[..., 0] - top2.values[..., 1]
    decided = gap > margin * dmax
    agree = got.argmax(-1) == want.argmax(-1)
    print(f"{label}: logits cosine min {cos.min().item():.6f} (floor 0.999), max |dlogit| "
          f"{dmax.max().item():.4f}; top-1 agrees on {int((agree & decided).sum())} of "
          f"{int(decided.sum())} slot-steps decided at a top-2 gap above {margin:g} x max "
          f"|dlogit|; {int((~decided).sum())} closer than that ({int((agree & ~decided).sum())} "
          f"agree)")
    for i in (~agree & (gap > dmax)).nonzero().tolist()[:4]:
        a, b = top2.indices[tuple(i)].tolist()
        print(f"  flipped at slot-step {i}: top-2 gap {gap[tuple(i)].item():.4f}, max |dlogit| "
              f"{dmax[tuple(i)].item():.4f}; the plain route's ({a}, {b}) "
              f"{want[tuple(i)][a].item():.4f}, {want[tuple(i)][b].item():.4f}, the kernel "
              f"route's {got[tuple(i)][a].item():.4f}, {got[tuple(i)][b].item():.4f}")
    expect(bool((cos >= 0.999).all()), f"{label}: cosine below 0.999")
    expect(bool(agree[decided].all()), f"{label}: top-1 differs where decided")
    return cos.min().item()


def paged_phase(torch, counters, card, model):
    """Slice 4b: Qwen2-7B generation at full width and depth over the paged
    KV cache with prefix caching and 512-token chunked prefill, on the
    dense phase's model.  Its main path is the serving launcher's
    ``launch.serve.serve_continuous`` (``LLM.generate`` inside it): 64
    requests of 512-1024 tokens, the even ones behind one shared 512-token
    preamble, 32 new tokens each, sampled with a seed a request, on 32
    slots and pages of 16, with its health lines every 64 steps, its
    metrics directory, its lifecycle trace and its step timer.  The checks
    after it run on its engine and load.  Returns the launch counts of the
    ``serve_continuous`` call."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.config import ServeConfig
    from repro_torch.launch.serve import serve_continuous
    from repro_torch.models.model import Model
    from repro_torch.serving.api import LLM
    from repro_torch.serving.engine import Request, to_host

    failed = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    cfg = model.cfg
    L = cfg.num_layers
    n, slots, prompt_len, new, chunk, page = 64, 32, 1024, 32, 512, 16
    # the launcher's ServeConfig for --prefix-cache (prompts up to twice
    # --prompt-len), seeded sampling
    sc = ServeConfig(max_seq_len=2 * prompt_len + new + 1, batch_size=slots, temperature=0.8,
                     top_k=50, top_p=0.95, seed=0, cache_layout="paged", page_size=page,
                     prefix_cache=True, prefill_chunk=chunk)
    max_len = sc.max_seq_len
    kw = dict(slots=slots, max_len=max_len, cache_layout="paged", page_size=page,
              prefix_cache=True, prefill_chunk=chunk)
    names = ("flash_attention_fwd", "flash_decode", "rmsnorm", "fused_sample", "paged_decode",
             "paged_prefill", "paged_kv_write")

    def zero():
        for name in names:
            counters[name].launches = 0
        counters["paged_decode"].appends = 0

    def read():
        got = {name: counters[name].launches for name in names}
        got["paged_decode.appends"] = counters["paged_decode"].appends
        return got

    # the main path: every count set to 0 just before, read just after; the
    # launcher's LLM, load and completions taken by wrapping LLM.generate
    captured = []
    generate = LLM.generate

    def spy(self, prompts, params=None, **kw):
        outs = generate(self, prompts, params, **kw)
        captured.append((self, prompts, params, outs))
        return outs

    tmp = tempfile.TemporaryDirectory()
    torch.cuda.reset_peak_memory_stats()
    zero()
    t0 = time.perf_counter()
    LLM.generate = spy
    try:
        serve_continuous(model, None, sc, gen=new, prompt_len=prompt_len, requests=n,
                         health_every=64, metrics_dir=f"{tmp.name}/metrics",
                         trace_path=f"{tmp.name}/trace.jsonl", profile=True)
        torch.cuda.synchronize()
    finally:
        LLM.generate = generate
    t_first = time.perf_counter() - t0
    launches = read()
    (llm, prompts, params, first), = captured
    eng = llm.engine
    eng.on_step = None      # the launcher's health lines end with its call
    plens = [len(p) for p in prompts]
    n_dec, n_chunk = eng.decode_steps, eng.prefill_chunks
    want = {"flash_attention_fwd": 0, "flash_decode": 0, "rmsnorm": (2 * L + 1) * (n_dec + n_chunk),
            "fused_sample": n + n_dec, "paged_decode": L * n_dec, "paged_prefill": L * n_chunk,
            "paged_kv_write": 0, "paged_decode.appends": L * n_dec}
    stats1 = dict(eng.alloc.stats)
    files = sorted(os.listdir(f"{tmp.name}/metrics"))
    events = [json.loads(ln) for ln in Path(f"{tmp.name}/trace.jsonl").read_text().splitlines()]
    finished = sum(e["event"] == "finish" for e in events)
    print(f"paged main path: serve_continuous of {n} requests ({sum(plens)} prompt tokens, the even "
          f"ones behind a 512-token preamble) on {slots} slots, pages of {page} "
          f"({eng.alloc.num_pages} pages, prefix cache, {chunk}-token chunks): {n_chunk} prefill "
          f"chunks, {n_dec} decode steps, {t_first:.2f} s (first call, set-up included); prefix "
          f"cache {stats1}; metrics files {files}, {len(events)} trace events ({finished} "
          f"finishes); launches {launches} (want {want})")
    expect(launches == want, "paged launch counts")
    expect(stats1["hit_tokens"] > 0, "no prefix-cache hit in the main run")
    expect(files == ["serve.prom", "serve_metrics.json"] and finished == n,
           "the launcher wrote no metrics files or trace events")
    gen = [len(c.tokens) for c in first]
    max_new = params[0].max_new
    expect(all(c.finish_reason == "length" for c in first) and gen == [max_new] * n,
           "paged finish reasons / lengths")
    eng.alloc.check_invariants()
    # the pool frees every page (the prefix cache's pages once it drops them)
    eng.alloc.drop_cache()
    expect(eng.alloc.free_pages == eng.alloc.num_pages - 1, "pages leaked after the main run")
    tmp.cleanup()

    # the steady call: the same load from a cold prefix cache (only the
    # preamble is shared), so it repeats the main call's hits exactly; with
    # log-probabilities, which change no token
    t0 = time.perf_counter()
    second = llm.generate(prompts, [dataclasses.replace(p, logprobs=True) for p in params])
    torch.cuda.synchronize()
    t_steady = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    same = all(a.tokens == b.tokens for a, b in zip(first, second))
    stats2 = {k: v - stats1[k] for k, v in eng.alloc.stats.items()}
    print(f"second call after alloc.drop_cache(), with log-probabilities: tokens identical to the "
          f"first {same}; its prefix cache {stats2}")
    expect(same, "a repeat after drop_cache differs")
    expect(all(np.isfinite(c.logprobs).all() for c in second), "paged non-finite logprobs")
    ttft = sorted(c.ttft_s for c in second)
    toks = sum(len(c.tokens) for c in second)
    print(f"Qwen2-7B paged LLM.generate on {card}: {toks / t_steady:.1f} generated tokens/s "
          f"({toks} tokens in {t_steady:.3f} s, steady call), TTFT p50 {1e3 * ttft[n // 2]:.1f} ms, "
          f"p95 {1e3 * ttft[int(0.95 * (n - 1))]:.1f} ms, peak memory {peak_gb:.2f} GB; first call "
          f"{t_first:.2f} s")
    eng.alloc.check_invariants()
    # a warm prefix cache (every prompt's full blocks cached by the calls
    # above): each prompt's first-token logits from it (the tail recomputed
    # from a page-aligned start, a whole-prompt hit through copy-on-write)
    # against a cold cache's
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
                 "fused_sample": 1, "paged_decode": L, "paged_prefill": 0, "paged_kv_write": 0,
                 "paged_decode.appends": L}
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
    # where a chunk's time goes: one 512-token chunk at start 512 through the
    # model over the engine's pools, profiled (its K/V rows land in pages
    # 1-128, which this engine, deleted next, no longer reads)
    pages = torch.arange(1, 1 + eng.cache["block_table"].shape[1], dtype=torch.int32,
                         device=model.device)[None]
    ids = torch.as_tensor(np.asarray([prompts[1][:chunk]], np.int32), device=model.device)
    model.prefill_chunk(model.params.tree(), eng.cache["layers"], ids, pages, chunk, chunk)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.prefill_chunk(model.params.tree(), eng.cache["layers"], ids, pages, chunk, chunk)
        torch.cuda.synchronize()
    busy_ms, groups, _ = kernel_groups(prof, DeviceType)
    print(f"profile of one 512-token chunk at start 512 on {card}: device busy {busy_ms:.3f} ms, "
          f"paged_prefill {groups['paged_prefill']:.3f} ms over its {cfg.num_layers} launches "
          f"({groups['paged_prefill'] / max(busy_ms, 1e-9):.1%})")
    del prof
    del llm, eng
    gc.collect()
    torch.cuda.empty_cache()

    # the paged kernel route against the plain route (kernel_impl="torch")
    # and against the dense kernel route, through the engine: 8 prompts
    # (four behind the preamble, one the preamble alone: a whole-prompt hit,
    # copy-on-write), chunked prefill, 32 teacher-forced decode steps with
    # per-slot positions and 24 idle slots
    order = [int(i) for i in np.argsort(plens)]
    # short to long; a preamble prompt (an even one) first, so that it
    # registers its blocks before the others are admitted
    picks = [i for i in order if i % 2 == 0][::8][:4] + [i for i in order if i % 2][::11][:3]
    preamble = prompts[0][:prompt_len // 2]
    route_prompts = [prompts[i] for i in picks] + [preamble]
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

    # preemption at full width: a tight pool, 8 requests of ~850-1 050
    # tokens (one runs at a time, so the decode steps cost most: 24 new
    # tokens each)
    tight = LLM(model, slots=8, max_len=max_len, cache_layout="paged", page_size=page,
                num_pages=1 + 100, prefix_cache=True, prefill_chunk=chunk, preempt=True)
    mid = order[20:36:2]
    pre_prompts = [prompts[i] for i in mid]
    pre_params = [dataclasses.replace(params[i], max_new=24) for i in mid]
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

        def spy(cfg, params, x, ctx=None):
            out, aux = apply(cfg, params, x, ctx)
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
    from repro_torch.models.model import build_model
    from repro_torch.serving.api import LLM
    from repro_torch.serving.engine import Request

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
    slots, max_len, n, max_new = 32, 2048, 64, 32
    lengths, prompts, params = generation_load(np, cfg.vocab_size, n, max_new)
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

    # kernel route against plain route through the engine, on the kernel
    # route's experts, and each MoE layer on its real input
    picks = [int(i) for i in np.argsort(lengths)[:: n // 8]]
    n_forced = 32
    forced = torch.zeros((n_forced, slots), dtype=torch.int32, device=model.device)
    for slot, i in enumerate(picks):
        forced[:, slot] = torch.tensor(first[i].tokens[:n_forced], dtype=torch.int32)
    moe_route_check(torch, np, model, dict(slots=slots, max_len=max_len),
                    [prompts[i] for i in picks], forced, expect)
    del model
    check(not failed, "MoE generation phase: " + "; ".join(failed))
    return launches


# The Scout route check's two bounds, each twice the largest reading of its
# statistic on sound kernels: 5 seeded draws of the phase's route prompts,
# each through the mma.sync gmm forward and three sound attention forwards
# (moe_route_faults.py --spread, on an H100), read 0.0871-0.1206 and 1-2
MOE_NEAR_TIE = 0.25     # the largest router margin, in log-probability, of a decision that flips
MOE_LAYER_STEPS = 4     # an MoE layer's output against the plain route's, in bf16 steps of each row's max
MOE_LAYER_FAULT = "an MoE layer differs from its plain route"


def moe_route_check(torch, np, model, engine_kw, route_prompts, forced, expect):
    """Llama-4-Scout's kernel route against its plain route through the
    engine (``engine_logits``: the prompts' exact-length prefills, then a
    teacher-forced decode step per row of ``forced``), the plain route put
    on the kernel route's experts (``RouteLog`` replay): top-1 routing of
    random weights flips at near-ties of the fp32 router over hidden
    states that the two routes round differently, and a flipped token
    moves the later ones through attention and capacity, so held free the
    two routes drift apart on the routing, not on the kernels' arithmetic.
    The flips are counted from the plain route's own router: at most 2% of
    the decisions, each a near-tie (the kernel route's margin of its choice
    at most ``MOE_NEAR_TIE``); the logits by ``compare_logits``; then
    ``moe_layer_check`` on the shortest and the longest prompt.  Returns
    the readings."""
    from repro_torch.models import moe
    from repro_torch.models.model import Model

    cfg = model.cfg
    L = cfg.num_layers
    plain = Model(dataclasses.replace(cfg, kernel_impl="torch"), model.params.tree())
    with RouteLog(moe) as k_log:
        k_lg, _ = engine_logits(torch, np, model, engine_kw, route_prompts, forced)
    with RouteLog(moe, replay=k_log.calls) as p_log:
        p_lg, _ = engine_logits(torch, np, plain, engine_kw, route_prompts, forced)
    npk, n_forced = len(route_prompts), forced.shape[0]
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
          f"near-tie: at most {MOE_NEAR_TIE}); {int(slot_flips.sum())} of {slot_flips.numel()} "
          f"slot-steps ({slot_flips.float().mean().item():.4f}) have one in some layer of the "
          f"compared token")
    expect(n_flip <= 0.02 * decisions, "the routes' routers disagree too often")
    expect(margin <= MOE_NEAR_TIE, "a routing difference between the routes is not a near-tie")
    cos_min = compare_logits(
        torch, k_lg, p_lg,
        f"Scout kernel path vs plain path through the engine on the same experts ({npk} slots of "
        f"{engine_kw['slots']}, prompts of {sorted(len(p) for p in route_prompts)} tokens, "
        f"exact-length prefill + {n_forced} teacher-forced decode steps)", expect)
    del k_lg, p_lg
    by_len = sorted(route_prompts, key=len)
    steps = moe_layer_check(torch, model, plain.cfg, [by_len[0], by_len[-1]], expect)
    return {"flips": n_flip, "decisions": decisions, "margin": margin, "cos_min": cos_min,
            "layer_steps": steps}


def moe_layer_check(torch, model, plain_cfg, prompts, expect):
    """Every MoE layer of the kernel route's prefill of each prompt against
    the plain route on the same input (the layer's real activations, on the
    kernel route's experts): the output within ``MOE_LAYER_STEPS`` bf16
    steps of each row's max|plain|.  Catches a gmm fault too small for the
    route check (``moe_route_faults.py``).  Returns the worst reading of
    each prompt, in steps."""
    from repro_torch.models import moe

    apply, worst = moe.moe_apply, []
    for prompt in prompts:
        seen = []

        def spy(cfg, params, x, ctx=None):
            with RouteLog(moe) as log:
                out, aux = apply(cfg, params, x, ctx)
            seen.append((params, x, out, log.calls))
            return out, aux

        moe.moe_apply = spy
        try:
            model.prefill(model.params.tree(),
                          {"tokens": torch.tensor([prompt], device=model.device)}, len(prompt))
        finally:
            moe.moe_apply = apply
        w = 0.0
        for params, x, out, calls in seen:
            with RouteLog(moe, replay=calls):
                want, _ = apply(plain_cfg, params, x)
            top = want.float().abs().amax(-1, keepdim=True).clamp_min(1e-30)
            step = torch.exp2(torch.floor(torch.log2(top)) - 7)
            w = max(w, ((out.float() - want.float()).abs() / step).max().item())
        worst.append(w)
        del seen
    print(f"each MoE layer on its real input (prompts of {[len(p) for p in prompts]} tokens): the "
          f"kernel route's output within {', '.join(f'{w:.3g}' for w in worst)} bf16 steps of "
          f"each row's max|plain| (tol {MOE_LAYER_STEPS})")
    expect(max(worst) <= MOE_LAYER_STEPS, MOE_LAYER_FAULT)
    return worst


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
    slots, max_len, n, max_new = 32, 2048, 64, 32
    lengths, prompts, params = generation_load(np, cfg.vocab_size, n, max_new)
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
    # where an admission's time goes: the exact-length prefill of the
    # median prompt, profiled
    mid = prompts[int(np.argsort(lengths)[n // 2])]
    tokens = torch.tensor([mid], device=model.device)
    model.prefill(model.params.tree(), {"tokens": tokens}, len(mid))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.prefill(model.params.tree(), {"tokens": tokens}, len(mid))
        torch.cuda.synchronize()
    busy_ms, groups, _ = kernel_groups(prof, DeviceType)
    print(f"profile of one Mamba2 admission ({len(mid)} tokens, the median prompt) on {card}: "
          f"device busy {busy_ms:.3f} ms, ssd_scan {groups['ssd_scan']:.3f} ms over its {L} "
          f"launches ({groups['ssd_scan'] / max(busy_ms, 1e-9):.1%})")
    del prof

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

    with RouteLog(moe) as k_log:
        k_loss, k_grads = loss_grads(torch, model, batch)
    again_loss, again = loss_grads(torch, model, batch)
    differ = [names[i] for i, (a, b) in enumerate(zip(k_grads, again)) if not torch.equal(a, b)]
    print(f"kernel route twice on one micro-batch: loss {k_loss!r} vs {again_loss!r}; "
          f"{len(differ)} of {len(names)} grad leaves differ {differ[:6]}")
    expect(k_loss == again_loss and not differ, "a repeated loss and backward is not bit-identical")
    del again
    with RouteLog(moe, replay=k_log.calls) as p_log:
        p_loss, p_grads = loss_grads(torch, plain, batch)
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
    counters["gmm"].dx_launches = 0
    torch.cuda.synchronize()
    trainer = Trainer(model, tc, pc=ParallelConfig(optimizer_state_dtype="bfloat16"),
                      peak_flops=PEAK_BF16_FLOPS)
    state, hist = trainer.run(pipe)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    launches["gmm dx"] = counters["gmm"].dx_launches      # gmm's transposed mode, of its count
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_moe = T.num_moe_layers(cfg)
    # the stack's forward kernels (attention, RMSNorm, the 3 forward gmm an
    # MoE layer) run fwd_runs times under remat; the final norm once
    r = fwd_runs(model.pc.remat_policy)
    want = dict.fromkeys(counters, 0)
    want.update(flash_attention_fwd=r * steps, flash_attention_bwd=steps,
                rmsnorm=(r * 2 * cfg.num_layers + 1) * steps, cross_entropy_fwd=steps,
                cross_entropy_bwd=steps, gmm=(3 * r + 3) * n_moe * steps,
                gmm_dw=3 * n_moe * steps)
    want["gmm dx"] = 3 * n_moe * steps
    print(f"main path: Trainer.run of {steps} steps, remat {model.pc.remat_policy}: launches "
          f"{launches} (want {want})")
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
        print("the grouped matmul's kernels in the step: " + ", ".join(
            f"{name[name.lower().index('gmm'):].split('(')[0]} {t:.3f} ms in {cnt}"
            for name, t, cnt in kern
            if "gmm" in name.lower()))
        for name, t, cnt in sorted(kern, key=lambda r: -r[1])[:14]:
            print(f"  {t:9.2f} ms {cnt:6d}x  {name[:110]}")
    del trainer, state, model, step_fn, prof, batch
    tmp.cleanup()
    gc.collect()
    torch.cuda.empty_cache()
    check(not failed, "MoE training phase: " + "; ".join(failed))
    return launches


SSM_ROUTE_DEPTH = 8   # the Mamba2 gradient route check's depth (of 64 layers)


def ssm_train_launches(cfg, policy: str):
    """The launches of one SSM or hybrid micro-batch's forward and
    backward under remat ``policy``: the SSD forward and backward a SSD
    layer, the attention forward and backward an attention layer, an
    RMSNorm before each mixer, one before each FFN (none where d_ff is 0,
    as in Mamba2) and the final one, gmm 6 (3 forward, 3 transposed for dx)
    and gmm_dw 3 an MoE layer, one cross-entropy forward and backward; each
    forward inside the stack ``fwd_runs(policy)`` times."""
    from repro_torch.models import transformer as T

    r = fwd_runs(policy)
    n_ssm = sum(not cfg.is_attn_layer(i) for i in range(cfg.num_layers))
    n_attn, n_moe = cfg.num_layers - n_ssm, T.num_moe_layers(cfg)
    return {"ssd_scan": r * n_ssm, "ssd_scan_bwd": n_ssm, "flash_attention_fwd": r * n_attn,
            "flash_attention_bwd": n_attn,
            "rmsnorm": r * (2 if cfg.d_ff > 0 else 1) * cfg.num_layers + 1,
            "cross_entropy_fwd": 1, "cross_entropy_bwd": 1, "gmm": (3 * r + 3) * n_moe,
            "gmm dx": 3 * n_moe, "gmm_dw": 3 * n_moe}


def read_launches(counters):
    out = {name: fn.launches for name, fn in counters.items()}
    out["gmm dx"] = counters["gmm"].dx_launches      # gmm's transposed mode, of its count
    return out


def zero_launches(counters):
    for fn in counters.values():
        fn.launches = 0
    counters["gmm"].dx_launches = 0


def loss_grads(torch, m, batch):
    """(loss, gradient of every leaf) of one ``loss_fn`` and backward."""
    from repro_torch.core.module import tree_leaves
    from repro_torch.core.precision import compute_view

    p = m.params.tree()
    loss, _ = m.loss_fn(compute_view(m.policy, p), batch)
    return loss.item(), torch.autograd.grad(loss, tree_leaves(p))


def report_route(torch, kernel, plain, fp32, names, label, expect):
    """Hold the kernel route's (loss, gradients) to the plain route's: the
    loss within 2e-2 and every leaf's cosine >= 0.999.  A leaf below that
    floor passes only where bf16 rounding alone moves it past it -- the
    plain route's own cosine to the fp32-compute route ``fp32`` is below
    0.999 -- and then the kernel route must be about as close to the fp32
    route as the plain route is (its 1 - cosine at most twice the plain
    route's), the idea of ``anchored_compare`` for Mamba2's logits.  At
    random weights the SSM leaves D and A sum tens of thousands of terms
    that cancel: two sound bf16 routes part there by a random factor of
    their distance to fp32, and a gross fault moves the leaf by far more.
    Those leaves' kernel is held to 1e-3 of the plain version by
    ``check_ssd_scan_bwd``."""
    (k_loss, k_grads), (p_loss, p_grads), (f_loss, f_grads) = kernel, plain, fp32
    cos = [cosine(torch, a, b) for a, b in zip(k_grads, p_grads)]
    anchored, bad = [], []
    for i, c in enumerate(cos):
        if c >= 0.999:
            continue
        kf, pf = cosine(torch, k_grads[i], f_grads[i]), cosine(torch, p_grads[i], f_grads[i])
        anchored.append(f"{names[i]} {c:.6f} (to fp32: kernel {kf:.6f}, plain {pf:.6f})")
        if pf >= 0.999 or 1 - kf > 2 * (1 - pf):
            bad.append(names[i])
    worst = min(range(len(cos)), key=lambda i: cos[i])
    print(f"{label}: loss {k_loss:.6f} vs {p_loss:.6f} (|diff| {abs(k_loss - p_loss):.3g}, tol "
          f"2e-2; fp32 route {f_loss:.6f}); grad cosine min {cos[worst]:.6f} ({names[worst]}, of "
          f"{len(cos)} leaves; floor 0.999), mean {statistics.mean(cos):.6f}")
    print("lowest grad cosines: " + ", ".join(
        f"{names[i]} {cos[i]:.6f}" for i in sorted(range(len(cos)), key=lambda i: cos[i])[:5]))
    print(f"leaves below 0.999 held to the fp32 route: {len(anchored)} {anchored[:8]}; failing: "
          f"{bad}")
    expect(abs(k_loss - p_loss) <= 2e-2, f"{label}: the loss disagrees")
    expect(not bad, f"{label}: the gradients disagree")


def ssm_train_phase(torch, counters, card):
    """The SSM training path: Mamba2-2.7B through ``Trainer.run`` at full
    width and all 64 layers (fp32 master weights, fp32 AdamW moments, WSD,
    remat at the default ``block``), 6 steps of packed synthetic protein
    tokens, one micro-batch of 2 x 1024 a step.  Before it, the gradient route check at full
    width and ``SSM_ROUTE_DEPTH`` layers: one micro-batch's loss and
    gradients twice on the kernel route (bit-identical) and once on the
    plain route (loss within 2e-2, every leaf's cosine >= 0.999); at 64
    random layers two sound routes part on rounding alone.  Returns the
    launch counts of the trainer's run and the peak memory in GB."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.config import TrainConfig
    from repro_torch.data.dataset import build_synthetic_protein_memmap
    from repro_torch.data.pipeline import CLMBatches
    from repro_torch.models.model import Model, build_model
    from repro_torch.training.loop import Trainer
    from repro_torch.training.train_step import make_train_step

    failed = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    t_phase = time.perf_counter()
    cfg = get_config("mamba2-2.7b")
    tmp = tempfile.TemporaryDirectory()
    ds, tok = build_synthetic_protein_memmap(f"{tmp.name}/prot", n=1024, seed=0)
    micro, seq, accum, steps = 2, 1024, 1, 6

    # ---- the gradient route check at a cut depth, on one 1 x 1024 micro-batch
    cut = dataclasses.replace(cfg, num_layers=SSM_ROUTE_DEPTH)
    model = build_model(cut, seed=0)
    plain = Model(dataclasses.replace(cut, kernel_impl="torch"), model.params.tree())
    batch = {k: torch.from_numpy(v).to(model.device)
             for k, v in next(iter(CLMBatches(ds, 1, seq, seed=1, eos_id=tok.eos_id))).items()}
    fp32 = Model(dataclasses.replace(cut, kernel_impl="torch", dtype="float32"),
                 model.params.tree())
    names = leaf_paths(model.params.tree())
    k_route = loss_grads(torch, model, batch)
    again = loss_grads(torch, model, batch)
    differ = [names[i] for i, (a, b) in enumerate(zip(k_route[1], again[1]))
              if not torch.equal(a, b)]
    print(f"Mamba2-2.7B at full width, {SSM_ROUTE_DEPTH} of 64 layers, kernel route twice on one "
          f"1x{seq} micro-batch: loss {k_route[0]!r} vs {again[0]!r}; {len(differ)} of "
          f"{len(names)} grad leaves differ {differ[:6]}")
    expect(k_route[0] == again[0] and not differ, "a repeated Mamba2 loss and backward differs")
    del again
    report_route(torch, k_route, loss_grads(torch, plain, batch), loss_grads(torch, fp32, batch),
                 names, f"Mamba2 kernel route vs plain route ({SSM_ROUTE_DEPTH} layers, loss_fn + "
                 f"backward, 1x{seq})", expect)
    del model, plain, fp32, k_route
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the main path: Trainer.run at full depth
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0)
    torch.cuda.synchronize()
    print(f"built {cfg.name} ({cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.ssm_nheads} SSD "
          f"heads of {cfg.d_inner // cfg.ssm_nheads}, state {cfg.ssm_state}, vocab "
          f"{cfg.vocab_size}, {cfg.param_count() / 1e9:.3f}B params, fp32 master weights) in "
          f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    tc = TrainConfig(global_batch=micro * accum, seq_len=seq, accum_steps=accum,
                     learning_rate=3e-4, min_lr=3e-5, warmup_steps=2, decay_steps=2,
                     total_steps=steps, schedule="wsd", weight_decay=0.01, grad_clip=1.0,
                     log_every=steps)
    print(f"training data: {len(ds)} synthetic sequences of 40-199 residues, packed with <eos> "
          f"into {micro}x{seq} micro-batches, accum {accum} ({micro * accum * seq} tokens a "
          f"step), AdamW with fp32 moments + WSD, peak lr {tc.learning_rate}, {steps} steps")
    pipe = CLMBatches(ds, micro * accum, seq, seed=0, eos_id=tok.eos_id)
    zero_launches(counters)
    torch.cuda.synchronize()
    trainer = Trainer(model, tc, peak_flops=PEAK_BF16_FLOPS)
    state, hist = trainer.run(pipe)
    torch.cuda.synchronize()
    launches = read_launches(counters)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = dict.fromkeys(launches, 0)
    want.update({k: v * steps * accum
                 for k, v in ssm_train_launches(cfg, model.pc.remat_policy).items()})
    print(f"main path: Trainer.run of {steps} steps x {accum} micro-batch of {micro}x{seq}, remat "
          f"{model.pc.remat_policy}: launches {launches} (want {want})")
    losses = [h["loss"] for h in hist]
    print(f"losses: step 0 {losses[0]:.4f}, step {steps - 1} {losses[-1]:.4f}")
    expect(len(hist) == 2 and all(x == x and abs(x) < 1e30 for x in losses), "non-finite loss")
    expect(trainer.skipped_total == 0, f"{trainer.skipped_total} skipped steps")
    expect(losses[-1] < losses[0], "the loss did not fall")
    expect(launches == want, "Mamba2 training launch counts")
    step_s = hist[-1]["step_time"]
    tokens = micro * accum * seq
    mfu = 6 * cfg.active_param_count() * tokens / step_s / PEAK_BF16_FLOPS
    print(f"Mamba2-2.7B (64 layers) training on {card}: step {step_s * 1e3:.1f} ms (wall of steps "
          f"1-{steps - 1} over {steps - 1}, one host transfer; step 0 with its transfer "
          f"{hist[0]['step_time'] * 1e3:.1f} ms), {tokens / step_s:.0f} tokens/s, MFU {mfu:.4f} "
          f"(6 x {cfg.active_param_count() / 1e9:.3f}B params x tokens / 989 TFLOP/s), peak "
          f"memory {peak_gb:.2f} GB")

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
        print(f"profile of one Mamba2 train step on {card}: wall {wall_ms:.1f} ms (under the "
              f"profiler), device busy {busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}; "
              f"the SSD backward {groups['ssd_scan_bwd']:.1f} ms "
              f"({groups['ssd_scan_bwd'] / busy_ms:.1%}), the forward {groups['ssd_scan']:.1f} ms")
        print("profile by group (other = glue with clip and AdamW): " + ", ".join(
            f"{k} {v:.1f} ms ({v / busy_ms:.1%})" for k, v in groups.items() if v))
        for name, t, cnt in sorted(kern, key=lambda r: -r[1])[:14]:
            print(f"  {t:9.2f} ms {cnt:6d}x  {name[:110]}")
    del trainer, state, model, step_fn, prof, batch
    tmp.cleanup()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"Mamba2 training phase: {time.perf_counter() - t_phase:.1f} s")
    check(not failed, "Mamba2 training phase: " + "; ".join(failed))
    return launches, peak_gb


def hybrid_train_phase(torch, counters, card):
    """The hybrid unit trains on the card: ``reduced()`` Jamba-1.5-Large
    (one unit of 8 layers: 7 SSD + 1 attention, MoE top-2 on every other
    layer) in bf16 with fp32 master weights through ``Trainer.run``, every
    kernel family counted; then one micro-batch's loss and gradients on the
    kernel route against the plain route on the kernel route's experts
    (loss within 2e-2, every leaf's cosine >= 0.999).  Returns the launch
    counts of the trainer's run."""
    from repro_torch.configs import get_config
    from repro_torch.core.config import TrainConfig, reduced
    from repro_torch.data.dataset import build_synthetic_protein_memmap
    from repro_torch.data.pipeline import CLMBatches
    from repro_torch.models import moe
    from repro_torch.models.model import Model, build_model
    from repro_torch.training.loop import Trainer

    failed = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    t_phase = time.perf_counter()
    cfg = reduced(get_config("jamba-1.5-large-398b"), dtype="bfloat16")
    model = build_model(cfg, seed=0)
    B, seq, steps = 4, 256, 4
    tmp = tempfile.TemporaryDirectory()
    ds, tok = build_synthetic_protein_memmap(f"{tmp.name}/prot", n=256, seed=0)
    batch = {k: torch.from_numpy(v).to(model.device)
             for k, v in next(iter(CLMBatches(ds, B, seq, seed=1, eos_id=tok.eos_id))).items()}
    plain = Model(dataclasses.replace(cfg, kernel_impl="torch"), model.params.tree())
    fp32 = Model(dataclasses.replace(cfg, kernel_impl="torch", dtype="float32"),
                 model.params.tree())
    with RouteLog(moe) as k_log:
        k_route = loss_grads(torch, model, batch)
    with RouteLog(moe, replay=k_log.calls):
        p_route = loss_grads(torch, plain, batch)
    with RouteLog(moe, replay=k_log.calls):
        f_route = loss_grads(torch, fp32, batch)
    report_route(torch, k_route, p_route, f_route, leaf_paths(model.params.tree()),
                 f"reduced Jamba kernel route vs plain route on the kernel route's experts "
                 f"(loss_fn + backward, {B}x{seq})", expect)
    del plain, fp32, k_route, p_route, f_route, k_log
    tc = TrainConfig(global_batch=B, seq_len=seq, learning_rate=1e-3, min_lr=1e-4, warmup_steps=1,
                     decay_steps=1, total_steps=steps, schedule="wsd", weight_decay=0.01,
                     grad_clip=1.0, log_every=steps)
    zero_launches(counters)
    trainer = Trainer(model, tc, peak_flops=PEAK_BF16_FLOPS)
    _, hist = trainer.run(CLMBatches(ds, B, seq, seed=0, eos_id=tok.eos_id))
    torch.cuda.synchronize()
    launches = read_launches(counters)
    want = dict.fromkeys(launches, 0)
    want.update({k: v * steps for k, v in ssm_train_launches(cfg, model.pc.remat_policy).items()})
    losses = [h["loss"] for h in hist]
    print(f"reduced {cfg.name} (bf16, fp32 master weights, {cfg.num_layers} layers) Trainer.run of "
          f"{steps} steps of {B}x{seq}: losses {losses[0]:.4f} -> {losses[-1]:.4f}, launches "
          f"{launches} (want {want}), {time.perf_counter() - t_phase:.1f} s")
    expect(launches == want, "reduced Jamba training launch counts")
    expect(trainer.skipped_total == 0 and all(x == x for x in losses), "a skipped step")
    expect(losses[-1] < losses[0], "the reduced Jamba loss did not fall")
    del trainer, model
    tmp.cleanup()
    check(not failed, "hybrid training phase: " + "; ".join(failed))
    return launches


def ssm_launcher_phase(torch, counters, card):
    """``launch.train.main --arch mamba2-2.7b`` on the card at full width and
    depth: 3 steps of size-aware batches under 1 024 tokens from the sharded
    store, so the SSD kernels see a new (B, S) at each step.  (``--smoke``'s
    reduced config is fp32, and the SSD kernels take bf16 only.)  Returns
    the launch counts of its run and the (B, S) shapes its trainer stepped
    on."""
    import contextlib
    import io

    from repro_torch.configs import get_config
    from repro_torch.core.config import ParallelConfig
    from repro_torch.launch import train as launch_train

    shapes = []

    class Recording(launch_train.Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            step_fn = self._step_fn
            self._step_fn = lambda st, b: (shapes.append(tuple(b["tokens"].shape)),
                                           step_fn(st, b))[1]

    tmp = tempfile.TemporaryDirectory()
    argv = ["--arch", "mamba2-2.7b", "--steps", "3", "--batch", "1", "--seq", "1024", "--lr",
            "3e-4", "--sharded-data", "--max-tokens-per-batch", "1024", "--mesh", "none",
            "--data-dir", f"{tmp.name}/data"]
    zero_launches(counters)
    out = io.StringIO()
    t0 = time.perf_counter()
    trainer_cls, launch_train.Trainer = launch_train.Trainer, Recording
    try:
        with contextlib.redirect_stdout(out):
            launch_train.main(argv)
    finally:
        launch_train.Trainer = trainer_cls
    torch.cuda.synchronize()
    launches = read_launches(counters)
    text = out.getvalue()
    want = dict.fromkeys(launches, 0)
    # launch.train.main builds its model with the default ParallelConfig
    want.update({k: v * 3 for k, v in ssm_train_launches(get_config("mamba2-2.7b"),
                                                          ParallelConfig().remat_policy).items()})
    keep = [ln for ln in text.splitlines() if ln.startswith(("arch=", "step ", "final loss"))]
    print(f"main path: launch.train.main {' '.join(argv[:-2])} ({time.perf_counter() - t0:.1f} s): "
          f"shapes {shapes}; launches {launches} (want {want})")
    print("launcher: " + " | ".join(keep))
    check(text.rstrip().splitlines()[-1].startswith("final loss"), "the launcher did not finish")
    check(launches == want, "Mamba2 launcher launch counts")
    check(len(set(shapes)) > 1, "the size-aware batches kept one shape")
    tmp.cleanup()
    return launches, set(shapes)


GENEFORMER_MASK_ID = 4           # <mask>; gene ids follow the five special tokens


def rank_value_cells(np, n, vocab, lengths=None, seed=0):
    """``n`` synthetic cells rank-value encoded as Geneformer's input (the
    encoding of ``examples/embed_cells_torch.py``) over the ``vocab - 5``
    genes of a vocabulary: Poisson expression profiles around three
    gamma-distributed cell types, each cell's genes ordered by expression,
    ids past the special tokens; cell i keeps its ``lengths[i]`` top genes
    (2 048 where no lengths are given)."""
    rng = np.random.default_rng(seed)
    centers = rng.gamma(2.0, 1.0, size=(3, vocab - 5))
    types = rng.integers(0, 3, size=n)
    expr = rng.poisson(centers[types] * 5).astype(np.float32)
    order = np.argsort(-expr, axis=1, kind="stable")[:, :2048].astype(np.int32) + 5
    lengths = np.full(n, 2048) if lengths is None else lengths
    return [order[i, : int(lengths[i])] for i in range(n)]


def geneformer_phase(torch, counters, card):
    """Geneformer-106M at full size: embedding serving through ``LLM.embed``
    of 96 rank-value-encoded cells of 256-2 048 genes, then MLM pre-training
    through ``Trainer.run`` (10 steps of 2 micro-batches of 8 x 2 048, the
    reference's ``mlm_2k`` length, 15% masking; fp32 master weights and
    AdamW moments, WSD).  Returns the launch counts of its two main paths,
    {"embed": ..., "train": ...}."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.config import TrainConfig
    from repro_torch.models.layers import _Lookup
    from repro_torch.models.model import Model, build_model
    from repro_torch.obs.trace import TraceRecorder
    from repro_torch.serving.api import LLM
    from repro_torch.training.loop import Trainer
    from repro_torch.training.train_step import make_train_step

    failed = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    cfg = get_config("geneformer-106m")
    L = cfg.num_layers
    names = ("flash_attention_fwd", "flash_attention_bwd", "layernorm", "layernorm_bwd",
             "cross_entropy_fwd", "cross_entropy_bwd")
    zero_launches(counters)
    model = build_model(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"built {cfg.name} ({L} layers, d_model {cfg.d_model}, {cfg.num_heads} heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} padded to {cfg.padded_vocab}, "
          f"learned positions up to {cfg.max_pos}, {n_params / 1e6:.1f}M params, fp32) on cuda, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")

    # ---- embedding serving: 96 cells of 256-2048 genes on 32 slots
    rng = np.random.default_rng(0)
    lengths = rng.integers(256, 2049, size=96)
    cells = [c.tolist() for c in rank_value_cells(np, 96, cfg.vocab_size, lengths, seed=0)]
    trace = TraceRecorder()
    llm = LLM(model, slots=32, max_len=2048, trace=trace)
    torch.cuda.reset_peak_memory_stats()
    zero_launches(counters)
    t0 = time.perf_counter()
    vecs = llm.embed(cells)
    t_first = time.perf_counter() - t0
    embed_launches = {k: counters[k].launches for k in names}
    buckets = [e["bucket"] for e in trace.events() if e["event"] == "prefill"]
    want = {"flash_attention_fwd": L * len(buckets), "flash_attention_bwd": 0,
            "layernorm": (2 * L + 1) * len(buckets), "layernorm_bwd": 0, "cross_entropy_fwd": 0,
            "cross_entropy_bwd": 0}
    print(f"Geneformer main path: LLM.embed of {len(cells)} cells ({int(lengths.sum())} genes), "
          f"{len(buckets)} dispatches over buckets {sorted(set(buckets))}: launches "
          f"{embed_launches} (want {want})")
    expect(embed_launches == want, "Geneformer embed launch counts")
    expect(vecs.shape == (96, cfg.d_model) and bool(np.isfinite(vecs).all()),
           f"Geneformer embeddings {vecs.shape}, finite {bool(np.isfinite(vecs).all())}")
    t0 = time.perf_counter()
    again = llm.embed(cells)
    t_steady = time.perf_counter() - t0
    expect(np.array_equal(vecs, again), "a second Geneformer embed call differs")
    plain = Model(dataclasses.replace(cfg, kernel_impl="torch"), model.params.tree())
    p_vecs = LLM(plain, slots=32, max_len=2048).embed(cells)
    cos = (vecs * p_vecs).sum(1) / (np.linalg.norm(vecs, axis=1) * np.linalg.norm(p_vecs, axis=1))
    print(f"Geneformer embed, kernel route vs plain route: min cosine {cos.min():.7f} (tol >= "
          f"0.9999); second call bit-identical {np.array_equal(vecs, again)}")
    expect(bool((cos >= 0.9999).all()), "Geneformer embeddings disagree with the plain route")
    del plain, p_vecs
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        llm.embed(cells)
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, groups, _ = kernel_groups(prof, DeviceType)
    print(f"Geneformer-106M LLM.embed on {card}: {len(cells) / t_steady:.1f} cells/s, "
          f"{int(lengths.sum()) / t_steady:.0f} genes/s (second call {t_steady:.3f} s, first "
          f"{t_first:.3f} s), peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
          f"profiled call: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f}; by group " + ", ".join(
              f"{k} {v:.1f} ms" for k, v in groups.items() if v))
    del llm, prof

    # ---- MLM pre-training at the reference's mlm_2k length
    micro, seq, accum, steps = 8, 2048, 2, 10
    tc = TrainConfig(global_batch=micro * accum, seq_len=seq, accum_steps=accum,
                     learning_rate=1e-4, min_lr=1e-5, warmup_steps=2, decay_steps=3,
                     total_steps=steps, schedule="wsd", weight_decay=0.01, beta2=0.98,
                     grad_clip=1.0, log_every=steps)
    pool = np.stack(rank_value_cells(np, 256, cfg.vocab_size, seed=1))    # (256, 2048) ids
    drng = np.random.default_rng(2)

    def batches():
        while True:
            t = pool[drng.integers(0, len(pool), size=tc.global_batch)]
            pick = drng.random(t.shape) < 0.15
            corrupted = np.where(pick, GENEFORMER_MASK_ID, t).astype(np.int32)
            yield {"tokens": corrupted, "targets": t, "loss_mask": pick.astype(np.float32)}

    zero_launches(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(model, tc, peak_flops=PEAK_BF16_FLOPS)
    fetches = []
    fetch = trainer._fetch
    trainer._fetch = lambda: (fetches.append(1), fetch())[1]
    state, hist = trainer.run(batches())
    torch.cuda.synchronize()
    train_launches = {k: counters[k].launches for k in names}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {k: v * steps * accum for k, v in step_launches(L, model.pc.remat_policy).items()}
    losses = [h["loss"] for h in hist]
    print(f"Geneformer main path: Trainer.run of {steps} steps x {accum} micro-batches of "
          f"{micro}x{seq}: launches {train_launches} (want {want}); losses step 0 {losses[0]:.4f}, "
          f"step {steps - 1} {losses[-1]:.4f}; host transfers {len(fetches)} (step 0, then one "
          f"for steps 1-{steps - 1})")
    expect(train_launches == want, "Geneformer training launch counts")
    expect(all(x == x and abs(x) < 1e30 for x in losses) and trainer.skipped_total == 0,
           "Geneformer: a non-finite loss or a skipped step")
    expect(losses[-1] < losses[0], "Geneformer: the loss did not fall")
    expect(len(fetches) == 2, "Geneformer: more than one host transfer over steps 1-9")
    step_s = hist[-1]["step_time"]
    tokens = micro * accum * seq
    mfu = 6 * cfg.active_param_count() * tokens / step_s / PEAK_BF16_FLOPS
    # QK^T and PV over every (query, key) pair, forward and backward (3x)
    attn_flops = 12 * cfg.num_heads * cfg.head_dim * seq * seq * L * micro * accum
    print(f"Geneformer-106M MLM training on {card}: step {step_s * 1e3:.1f} ms (wall of steps 1-"
          f"{steps - 1} over {steps - 1}), {tokens / step_s:.0f} tokens/s, MFU {mfu:.4f} (6 x "
          f"{cfg.active_param_count() / 1e6:.1f}M params x tokens / 989 TFLOP/s; with the "
          f"attention's {attn_flops / 1e12:.2f} TFLOP a step "
          f"{(6 * cfg.active_param_count() * tokens + attn_flops) / step_s / PEAK_BF16_FLOPS:.4f}), "
          f"peak memory {peak_gb:.2f} GB")

    # where a step's time goes, and the one-hot lookup's share of it
    batch = {k: torch.from_numpy(v).to(model.device) for k, v in next(batches()).items()}
    step_fn = make_train_step(model, tc)
    step_fn(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, groups, kern = kernel_groups(prof, DeviceType)
    table = model.params.tree()["embed"]["tok"].detach().to(torch.bfloat16).requires_grad_(True)
    ids = batch["tokens"][:micro].long()
    dy = torch.randn(*ids.shape, cfg.d_model, device=model.device, dtype=torch.bfloat16)
    looked = _Lookup.apply(table, ids)
    lookup_ms = time_ms(torch, lambda: torch.autograd.grad(looked, table, dy, retain_graph=True),
                        trials=5, per_trial=5)
    if busy_ms == 0:
        print("profile: the profiler saw no device time")
    else:
        print(f"profile of one Geneformer train step ({accum} micro-batches) on {card}: wall "
              f"{wall_ms:.1f} ms (under the profiler), device busy {busy_ms:.1f} ms, idle share "
              f"{1 - busy_ms / wall_ms:.3f}")
        print("profile by group: " + ", ".join(
            f"{k} {v:.1f} ms ({v / busy_ms:.1%})" for k, v in groups.items() if v))
        for name, t, cnt in sorted(kern, key=lambda r: -r[1])[:10]:
            print(f"  {t:9.2f} ms {cnt:6d}x  {name[:110]}")
        print(f"the embedding lookup's one-hot backward ({ids.numel()} ids x {cfg.padded_vocab} "
              f"rows x {cfg.d_model}, {2 * ids.numel() * cfg.padded_vocab * cfg.d_model / 1e12:.2f} "
              f"TFLOP) on {card}: {lookup_ms:.3f} ms a micro-batch, {accum * lookup_ms:.2f} ms "
              f"({accum * lookup_ms / busy_ms:.1%}) of the step's device time")
    del prof, table, looked, dy

    # the kernel route against the plain route: loss and every gradient leaf
    # on a 2 x 2048 batch; a leaf below 0.999 is held to the fp32-compute
    # route (``report_route``): without RoPE the key bias's exact gradient
    # is 0, so both routes hold only rounding noise there
    small = {k: v[:2].contiguous() for k, v in batch.items()}
    plain = Model(dataclasses.replace(cfg, kernel_impl="torch"), model.params.tree())
    fp32 = Model(dataclasses.replace(cfg, kernel_impl="torch", dtype="float32"),
                 model.params.tree())
    report_route(torch, loss_grads(torch, model, small), loss_grads(torch, plain, small),
                 loss_grads(torch, fp32, small), leaf_paths(model.params.tree()),
                 "Geneformer kernel route vs plain route (loss_fn + backward, 2x2048)", expect)
    del trainer, state, model, plain, fp32, step_fn, batch, small
    gc.collect()
    torch.cuda.empty_cache()
    check(not failed, "Geneformer phase: " + "; ".join(failed))
    return {"embed": embed_launches, "train": train_launches}


# the zoo's decoders on one card: (name, layers kept of the config's)
ZOO_DECODERS = (("command-r-35b", 8), ("qwen1.5-32b", 8), ("llama3-405b", 2))
ZOO_KERNELS = ("flash_attention_fwd", "flash_decode", "rmsnorm", "layernorm", "fused_sample",
               "paged_decode", "paged_prefill", "paged_kv_write")


def zoo_generate(torch, counters, card, model, label, engine_kw, load, expect, want_for=None):
    """One generation path of a zoo decoder through ``LLM.generate``: the
    main call (32 prompts on 32 slots; every count set to 0 just before,
    read just after, held to its want), then the steady decode loop at full
    slots (one step's launches, 8 steps with one host transfer each and no
    other sync, 16 timed, 8 profiled).  ``want_for(admissions, chunks,
    steps)`` gives the wanted counts where the decoder stack's own do not
    hold (an encoder, cross-attention, the paged layout without chunks).
    Returns (launches, completions)."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.api import LLM
    from repro_torch.serving.engine import Request, to_host

    cfg = model.cfg
    L = cfg.num_layers
    norm = "layernorm" if cfg.norm_type.startswith("layernorm") else "rmsnorm"
    norms = (1 if cfg.parallel_residual else 2) * L + 1       # a forward's norms
    paged = engine_kw.get("cache_layout") == "paged"
    prompts, params = load
    n = len(prompts)
    llm = LLM(model, **engine_kw)
    eng = llm.engine

    def zero():
        for k in ZOO_KERNELS:
            counters[k].launches = 0
        counters["paged_decode"].appends = 0

    def read():
        got = {k: counters[k].launches for k in ZOO_KERNELS}
        got["paged_decode.appends"] = counters["paged_decode"].appends
        return got

    def stack_want(admissions, chunks, steps):
        w = dict.fromkeys(ZOO_KERNELS, 0)
        w[norm] = norms * ((chunks if paged else admissions) + steps)
        w["fused_sample"] = admissions + steps
        if paged:
            w.update(paged_prefill=L * chunks, paged_decode=L * steps)
        else:
            w.update(flash_attention_fwd=L * admissions, flash_decode=L * steps)
        w["paged_decode.appends"] = L * steps if paged else 0
        return w

    want_for = want_for or stack_want
    torch.cuda.reset_peak_memory_stats()
    zero()
    dec0, ch0 = eng.decode_steps, eng.prefill_chunks
    t0 = time.perf_counter()
    first = llm.generate(prompts, params)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = read()
    n_dec, n_chunk = eng.decode_steps - dec0, eng.prefill_chunks - ch0
    want = want_for(n, n_chunk, n_dec)
    toks = sum(len(c.tokens) for c in first)
    ttft = sorted(c.ttft_s for c in first)
    stats = dict(eng.alloc.stats) if paged else {}
    print(f"{label} main path: LLM.generate of {n} prompts ({sum(len(p) for p in prompts)} prompt "
          f"tokens) on {engine_kw['slots']} slots: {n_chunk} prefill chunks, {n_dec} decode steps, "
          f"{toks / t_first:.1f} generated tokens/s ({toks} in {t_first:.2f} s, set-up included), "
          f"TTFT p50 {1e3 * ttft[n // 2]:.1f} ms, p95 {1e3 * ttft[int(0.95 * (n - 1))]:.1f} ms"
          f"{f', prefix cache {stats}' if paged else ''}; launches {launches} (want {want})")
    expect(launches == want, f"{label}: launch counts")
    expect(all(c.finish_reason == "length" and len(c.tokens) == params[i].max_new
               for i, c in enumerate(first)), f"{label}: finish reasons / lengths")
    expect(all(np.isfinite(c.logprobs).all() for c in first if c.logprobs),
           f"{label}: non-finite logprobs")
    if engine_kw.get("prefix_cache"):
        expect(stats.get("hit_tokens", 0) > 0, f"{label}: no prefix-cache hit")

    # the steady decode loop at full slots
    slots = engine_kw["slots"]
    for i in range(slots):
        eng.submit(Request(uid=30_000 + i, prompt=np.asarray(prompts[i], np.int32),
                           params=dataclasses.replace(params[i], max_new=48)))
    eng.step()
    while eng._prefilling or eng.queue:
        eng.step()
    zero()
    eng.step()
    per_step = read()
    print(f"{label}: one steady decode step's launches {per_step}")
    expect(per_step == want_for(0, 0, 1), f"{label}: launches per decode step")
    transfers = to_host.transfers
    for _ in range(8):
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng.step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    transfers = to_host.transfers - transfers
    expect(transfers == 8, f"{label}: a steady step made another transfer")
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
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"{label} decode step of {slots} slots on {card}: {step_ms:.2f} ms "
          f"({slots / step_ms * 1e3:.0f} tokens/s at full slots), peak memory {peak_gb:.2f} GB; "
          f"8 steps under set_sync_debug_mode('error'): {transfers} host transfers")
    if busy_ms == 0:
        print("profile: the profiler saw no device time")
    else:
        print(f"profile of 8 {label} decode steps on {card}: wall {wall_ms:.1f} ms, device busy "
              f"{busy_ms:.1f} ms ({busy_ms / 8:.3f} ms a step), idle share "
              f"{1 - busy_ms / wall_ms:.3f}")
        print("profile by group, per step: " + ", ".join(
            f"{k} {v / 8:.3f} ms ({v / busy_ms:.1%})" for k, v in groups.items() if v))
        for name, t, cnt in sorted(kern, key=lambda r: -r[1])[:8]:
            print(f"  {t:9.2f} ms {cnt:6d}x  {name[:110]}")
    del prof
    for r in list(eng.slot_req):
        if r is not None:
            eng.cancel(r)
    eng.run()
    if paged:
        eng.alloc.check_invariants()
        print(f"{label}: free pages after the run {eng.alloc.free_pages} of "
              f"{eng.alloc.num_pages - 1}")
        expect(eng.alloc.free_pages == eng.alloc.num_pages - 1, f"{label}: pages leaked")
    return launches, first


def zoo_decoder_phase(torch, counters, card, name, depth):
    """A zoo decoder generating at full width with ``depth`` of its layers
    (bf16, seeded random weights) through ``LLM.generate`` on 32 slots over
    a 2 048-token dense cache: 32 prompts of 64-1 024 tokens, 64 new, half
    greedy; Command-R also over the paged cache (prefix cache, 512-token
    chunks, 64 prompts, half of them behind a shared 512-token preamble).  Each
    path's kernel route is held to the plain route on forced prompts.
    Returns each path's launch counts, {"dense": ..., "paged": ...}."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, build_model

    failed = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    full = get_config(name)
    cfg = dataclasses.replace(full, num_layers=depth, param_dtype="bfloat16")
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"built {name} cut to {depth} of {full.num_layers} layers at full width (d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.norm_type}"
          f"{', parallel residual' if cfg.parallel_residual else ''}, "
          f"{cfg.param_count() / 1e9:.2f}B params, bf16) in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    slots, max_len, n, max_new = 32, 2048, 32, 64
    lengths, prompts, params = generation_load(np, cfg.vocab_size, n, max_new, seed=3)
    dense_kw = dict(slots=slots, max_len=max_len)
    label = f"{name} ({depth} layers)"
    out = {}
    out["dense"], first = zoo_generate(torch, counters, card, model, f"{label} dense", dense_kw,
                                       (prompts, params), expect)
    gc.collect()
    torch.cuda.empty_cache()
    plain = Model(dataclasses.replace(cfg, kernel_impl="torch"), model.params.tree())
    picks = [int(i) for i in np.argsort(lengths)[:: n // 4]]     # 4 prompts, short to long
    n_forced = 16
    forced = torch.zeros((n_forced, slots), dtype=torch.int32, device=model.device)
    for slot, i in enumerate(picks):
        forced[:, slot] = torch.tensor(first[i].tokens[:n_forced], dtype=torch.int32)
    route = [prompts[i] for i in picks]
    k_lg, _ = engine_logits(torch, np, model, dense_kw, route, forced)
    p_lg, _ = engine_logits(torch, np, plain, dense_kw, route, forced)
    compare_logits(torch, k_lg, p_lg, f"{label} kernel route vs plain route, dense cache (4 slots "
                   f"of {slots}, prompts of {sorted(int(lengths[i]) for i in picks)} tokens, "
                   f"{n_forced} forced decode steps)", expect)
    del k_lg, p_lg
    if cfg.parallel_residual:
        # the paged layout: a shared preamble in front of half the prompts
        # 64 prompts on 32 slots, as paged_phase, so that the second wave's
        # admissions find the first wave's preamble blocks
        plengths, pprompts, pparams = generation_load(np, cfg.vocab_size, 2 * n, max_new, seed=4)
        preamble = np.random.default_rng(4).integers(0, cfg.vocab_size, size=512).tolist()
        pp = [preamble + p if i % 2 else list(p) for i, p in enumerate(pprompts)]
        paged_kw = dict(slots=slots, max_len=max_len, cache_layout="paged", page_size=16,
                        prefix_cache=True, prefill_chunk=512)
        out["paged"], pfirst = zoo_generate(torch, counters, card, model, f"{label} paged",
                                            paged_kw, (pp, pparams), expect)
        gc.collect()
        torch.cuda.empty_cache()
        # a preamble prompt first, so that it registers its blocks before the
        # others are admitted; the preamble alone last (a whole-prompt hit)
        odd = sorted(range(1, 2 * n, 2), key=lambda i: plengths[i])
        even = sorted(range(0, 2 * n, 2), key=lambda i: plengths[i])
        ppicks = [odd[0], even[0], odd[-1], even[-1]]
        route = [pp[i] for i in ppicks] + [list(preamble)]
        pforced = torch.zeros((n_forced, slots), dtype=torch.int32, device=model.device)
        for slot, i in enumerate(ppicks + [ppicks[0]]):
            pforced[:, slot] = torch.tensor(pfirst[i].tokens[:n_forced], dtype=torch.int32)
        k_lg, k_stats = engine_logits(torch, np, model, paged_kw, route, pforced, warm=1)
        p_lg, _ = engine_logits(torch, np, plain, paged_kw, route, pforced, warm=1)
        print(f"{label} paged route: prompts of {[len(p) for p in route]} tokens, prefix cache "
              f"{k_stats}")
        expect(k_stats.get("hit_tokens", 0) > 0, f"{label}: the paged route had no prefix hit")
        compare_logits(torch, k_lg, p_lg, f"{label} kernel route vs plain route, paged cache",
                       expect)
        del k_lg, p_lg
    del plain, model
    gc.collect()
    torch.cuda.empty_cache()
    check(not failed, f"{name} generation phase: " + "; ".join(failed))
    return out


# ---------------------------------------------------------------- slice 7
INTERNVL2_DEPTH = 48      # of its 48 layers: the whole model fits one card in bf16


def frontend_want(cfg, paged):
    """``want_for(admissions, chunks, steps)`` of an encoder-decoder's or a
    vision model's serving path (``zoo_generate``): an admission's prefill
    runs the encoder (an attention and two norms a layer, its final norm)
    and the decoder (self- and cross-attention, three norms a layer and the
    final one; a vision model two norms, no cross); a decode step the
    decoder, its self-attention over the dense or the paged cache and its
    cross-attention over the dense per-slot cross cache; one fused_sample
    each."""
    L = cfg.num_layers
    enc = cfg.encoder_layers if cfg.is_encoder_decoder else 0
    cross = L if cfg.is_encoder_decoder else 0
    norm = "layernorm" if cfg.norm_type.startswith("layernorm") else "rmsnorm"
    step_norms = (3 if cross else 2) * L + 1
    fwd_norms = step_norms + (2 * enc + 1 if enc else 0)

    def want(admissions, chunks, steps):
        w = dict.fromkeys(ZOO_KERNELS, 0)
        w[norm] = fwd_norms * admissions + step_norms * steps
        w["fused_sample"] = admissions + steps
        w["flash_attention_fwd"] = (enc + L + cross) * admissions
        w["flash_decode"] = (cross + (0 if paged else L)) * steps
        w["paged_decode"] = L * steps if paged else 0
        w["paged_decode.appends"] = w["paged_decode"]
        return w

    return want


def static_decode_profile(torch, model, cache, tokens, card, label, steps=8):
    """``steps`` decode steps of ``model`` from ``cache`` (teacher-forced
    with ``tokens`` (B, steps)) under the profiler: device busy a step,
    idle share, device time by group.  Returns the busy ms a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    params = model.params.tree()
    model.decode_step(params, cache, tokens[:, :1])          # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(steps):
            model.decode_step(params, cache, tokens[:, t:t + 1])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, groups, kern = kernel_groups(prof, DeviceType)
    if busy_ms == 0:
        print("profile: the profiler saw no device time")
        return None
    print(f"profile of {steps} {label} decode steps (B {tokens.shape[0]}) on {card}: wall "
          f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms ({busy_ms / steps:.3f} ms a step), idle "
          f"share {1 - busy_ms / wall_ms:.3f}")
    print("profile by group, per step: " + ", ".join(
        f"{k} {v / steps:.3f} ms ({v / busy_ms:.1%})" for k, v in groups.items() if v))
    for name, t, cnt in sorted(kern, key=lambda r: -r[1])[:6]:
        print(f"  {t:9.2f} ms {cnt:6d}x  {name[:110]}")
    return busy_ms / steps


def forced_route(torch, model, plain, batch, max_len, forced, label, expect):
    """The kernel route against the plain route over a static batch: the
    prefill's last-row logits, then one decode step per column of
    ``forced`` (B, steps) fed to both (teacher forcing), through
    ``compare_logits``.  Returns the kernel route's cache after the steps."""
    params = model.params.tree()
    k_lg, k_cache = model.prefill(params, batch, max_len)
    p_lg, p_cache = plain.prefill(params, batch, max_len)
    got, want = [k_lg[:, -1].float()], [p_lg[:, -1].float()]
    for t in range(forced.shape[1]):
        k_lg, k_cache = model.decode_step(params, k_cache, forced[:, t:t + 1])
        p_lg, p_cache = plain.decode_step(params, p_cache, forced[:, t:t + 1])
        got.append(k_lg[:, -1].float())
        want.append(p_lg[:, -1].float())
    V = model.cfg.vocab_size
    got, want = torch.stack(got)[..., :V], torch.stack(want)[..., :V]
    cos = torch.nn.functional.cosine_similarity(got[0], want[0], dim=-1)
    print(f"{label}: first-token logits cosine min {cos.min().item():.6f} (floor 0.999)")
    compare_logits(torch, got, want, f"{label} ({forced.shape[0]} rows, the prefill then "
                   f"{forced.shape[1]} forced decode steps)", expect, margin=2.0)
    del p_cache, got, want
    return k_cache


def molmim_phase(torch, counters, card):
    """MolMIM-65M at full size (44.8 M parameters, fp32 master weights,
    bf16 compute): seq2seq training through ``launch.train.make_batches``
    (``Seq2SeqBatches``: the reference launcher's CLM packing with
    ``src_tokens`` mirroring ``tokens``) and ``Trainer.run``, 10 steps of 2
    micro-batches of 128 x 128 tokens with fp32 moments; then static-batch
    generation through ``launch.serve.generate``: 64 SMILES sources
    (``synthetic_smiles_sequences`` through ``SmilesTokenizer``, padded to
    128 tokens), prompts of their first 8 tokens, 64 new tokens, one greedy
    and one seeded sampled call.  Returns each run's launch counts."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.config import TrainConfig
    from repro_torch.data.dataset import synthetic_smiles_sequences
    from repro_torch.data.tokenizer import SmilesTokenizer
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch.train import Seq2SeqBatches, make_batches
    from repro_torch.models.model import Model, build_model
    from repro_torch.training.loop import Trainer
    from repro_torch.training.train_step import make_train_step

    failed = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    cfg = get_config("molmim-65m")
    L, E = cfg.num_layers, cfg.encoder_layers
    names = ("flash_attention_fwd", "flash_attention_bwd", "layernorm", "layernorm_bwd",
             "cross_entropy_fwd", "cross_entropy_bwd")
    model = build_model(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"built {cfg.name} ({E} encoder + {L} decoder layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} padded "
          f"to {cfg.padded_vocab}, {n_params / 1e6:.2f}M params ({cfg.param_count() / 1e6:.2f}M "
          f"analytic), fp32) on cuda")

    # ---- seq2seq training
    micro, seq, accum, steps = 128, 128, 2, 10
    tc = TrainConfig(global_batch=micro * accum, seq_len=seq, accum_steps=accum,
                     learning_rate=3e-4, min_lr=3e-5, warmup_steps=2, decay_steps=3,
                     total_steps=steps, schedule="wsd", weight_decay=0.01, grad_clip=1.0,
                     log_every=steps)
    tmp = tempfile.TemporaryDirectory()
    batches = make_batches(cfg, tc, f"{tmp.name}/data", seed=0)
    expect(isinstance(batches, Seq2SeqBatches), "make_batches gave no Seq2SeqBatches")
    # a micro-batch: the encoder's attention and two LayerNorms a layer and
    # its final norm, the decoder's self- and cross-attention and three
    # LayerNorms a layer and its final norm, each attention's and each
    # LayerNorm's backward, one cross-entropy forward and backward; under
    # remat both stacks' forward kernels (not the final norms) fwd_runs times
    r = fwd_runs(model.pc.remat_policy)
    per_micro = {"flash_attention_fwd": r * (E + 2 * L), "flash_attention_bwd": E + 2 * L,
                 "layernorm": r * (2 * E + 3 * L) + 2, "layernorm_bwd": 2 * E + 1 + 3 * L + 1,
                 "cross_entropy_fwd": 1, "cross_entropy_bwd": 1}
    zero_launches(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(model, tc, peak_flops=PEAK_BF16_FLOPS)
    fetches = []
    fetch = trainer._fetch
    trainer._fetch = lambda: (fetches.append(1), fetch())[1]
    state, hist = trainer.run(batches)
    torch.cuda.synchronize()
    train_launches = {k: counters[k].launches for k in names}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {k: v * steps * accum for k, v in per_micro.items()}
    losses = [h["loss"] for h in hist]
    print(f"MolMIM main path: Trainer.run over make_batches' Seq2SeqBatches, {steps} steps x "
          f"{accum} micro-batches of {micro}x{seq}: launches {train_launches} (want {want}); losses "
          f"step 0 {losses[0]:.4f}, step {steps - 1} {losses[-1]:.4f}; host transfers "
          f"{len(fetches)}")
    expect(train_launches == want, "MolMIM training launch counts")
    expect(all(x == x and abs(x) < 1e30 for x in losses) and trainer.skipped_total == 0,
           "MolMIM: a non-finite loss or a skipped step")
    expect(losses[-1] < losses[0], "MolMIM: the loss did not fall")
    expect(len(fetches) == 2, "MolMIM: more than one host transfer over steps 1-9")
    step_s = hist[-1]["step_time"]
    tokens = micro * accum * seq
    mfu = 6 * cfg.active_param_count() * tokens / step_s / PEAK_BF16_FLOPS
    print(f"MolMIM-65M seq2seq training on {card}: step {step_s * 1e3:.2f} ms (wall of steps 1-"
          f"{steps - 1} over {steps - 1}), {tokens / step_s:.0f} tokens/s, MFU {mfu:.4f} (6 x "
          f"{cfg.active_param_count() / 1e6:.1f}M params x {tokens} tokens / 989 TFLOP/s), peak "
          f"memory {peak_gb:.2f} GB")
    batch = {k: torch.as_tensor(v, device=model.device) for k, v in next(iter(batches)).items()}
    step_fn = make_train_step(model, tc)
    step_fn(state, batch)
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
        print(f"profile of one MolMIM train step ({accum} micro-batches) on {card}: wall "
              f"{wall_ms:.1f} ms (under the profiler), device busy {busy_ms:.1f} ms, idle share "
              f"{1 - busy_ms / wall_ms:.3f}")
        print("profile by group: " + ", ".join(
            f"{k} {v:.2f} ms ({v / busy_ms:.1%})" for k, v in groups.items() if v))
        for name, t, cnt in sorted(kern, key=lambda r: -r[1])[:8]:
            print(f"  {t:9.2f} ms {cnt:6d}x  {name[:110]}")
    del prof
    # the kernel route against the plain route on one micro-batch: a key
    # bias with no RoPE after it (cross-attention's) has an exact gradient
    # of 0, so report_route holds it to the fp32-compute route
    small = {k: v[:micro].contiguous() for k, v in batch.items()}
    plain = Model(dataclasses.replace(cfg, kernel_impl="torch"), model.params.tree())
    fp32 = Model(dataclasses.replace(cfg, kernel_impl="torch", dtype="float32"),
                 model.params.tree())
    report_route(torch, loss_grads(torch, model, small), loss_grads(torch, plain, small),
                 loss_grads(torch, fp32, small), leaf_paths(model.params.tree()),
                 f"MolMIM kernel route vs plain route (loss_fn + backward, {micro}x{seq})", expect)
    del trainer, state, step_fn, batch, small, fp32
    tmp.cleanup()
    gc.collect()
    torch.cuda.empty_cache()

    # ---- static-batch generation through launch.serve.generate
    n, src_len, prompt_len, new = 64, 128, 8, 64
    tok = SmilesTokenizer()
    src = tok.encode_batch(synthetic_smiles_sequences(n, seed=0), src_len)
    gen_batch = {"tokens": src[:, :prompt_len], "src_tokens": src}
    max_len = prompt_len + new
    gen_names = ("flash_attention_fwd", "flash_decode", "layernorm", "fused_sample")
    # the prefill: encoder and decoder as in training; each of the `new`
    # decode steps: self- and cross-attention a layer, 3L + 1 LayerNorms
    want = {"flash_attention_fwd": E + 2 * L, "flash_decode": 2 * L * new,
            "layernorm": 2 * E + 1 + (3 * L + 1) * (1 + new), "fused_sample": new}
    runs, toks = {}, {}
    for label, kw in (("greedy", {}), ("sampled", dict(temperature=0.8, top_k=50, top_p=0.95,
                                                         seed=7))):
        zero_launches(counters)
        t0 = time.perf_counter()
        toks[label], tok_s = launch_serve.generate(model, None, gen_batch, max_len=max_len,
                                                   steps=new, **kw)
        wall = time.perf_counter() - t0
        runs[label] = {k: counters[k].launches for k in gen_names}
        t = toks[label]
        print(f"MolMIM main path: launch.serve.generate {label} of {n} SMILES sources of {src_len} "
              f"tokens, prompts of {prompt_len}, {new} new on {card}: {tok_s:.0f} generated "
              f"tokens/s over the decode loop ({wall:.3f} s with the prefill); launches "
              f"{runs[label]} (want {want})")
        expect(runs[label] == want, f"MolMIM generate {label}: launch counts")
        expect(t.shape == (n, new) and bool(((t >= 0) & (t < cfg.vocab_size)).all()),
               f"MolMIM generate {label}: tokens {tuple(t.shape)} out of the vocab")
    again, _ = launch_serve.generate(model, None, gen_batch, max_len=max_len, steps=new)
    print(f"MolMIM generate: a repeated greedy call bit-identical: "
          f"{torch.equal(again, toks['greedy'])}; greedy and sampled differ in "
          f"{int((toks['greedy'] != toks['sampled']).sum())} of {n * new} tokens")
    expect(torch.equal(again, toks["greedy"]), "MolMIM generate: a repeat differs")
    dev_batch = {k: torch.as_tensor(v, device=model.device) for k, v in gen_batch.items()}
    cache = forced_route(torch, model, plain, dev_batch, max_len, toks["greedy"][:, :16],
                         "MolMIM kernel route vs plain route, launch.serve.generate", expect)
    static_decode_profile(torch, model, cache, toks["greedy"][:, 16:], card, "MolMIM static")
    del plain, cache, model
    gc.collect()
    torch.cuda.empty_cache()
    check(not failed, "MolMIM phase: " + "; ".join(failed))
    return {"molmim_train": train_launches, "molmim_generate_greedy": runs["greedy"],
            "molmim_generate_sampled": runs["sampled"]}


def frontend_routes(torch, np, model, plain, kw, prompts, first, label, expect):
    """The kernel route against the plain route through the engine
    (``engine_logits``): 4 prompts, short to long, 16 forced steps of the
    main call's own tokens."""
    n_forced = 16
    lens = [len(p) for p in prompts]
    picks = [int(i) for i in np.argsort(lens)[:: max(len(prompts) // 4, 1)]][:4]
    forced = torch.zeros((n_forced, kw["slots"]), dtype=torch.int32, device=model.device)
    for slot, i in enumerate(picks):
        forced[:, slot] = torch.tensor(first[i].tokens[:n_forced], dtype=torch.int32)
    route = [prompts[i] for i in picks]
    k_lg, _ = engine_logits(torch, np, model, kw, route, forced)
    p_lg, _ = engine_logits(torch, np, plain, kw, route, forced)
    compare_logits(torch, k_lg, p_lg, f"{label} (4 slots of {kw['slots']}, prompts of "
                   f"{sorted(lens[i] for i in picks)} tokens, {n_forced} forced decode steps)",
                   expect, margin=2.0)


def same_greedy(first, pfirst, params, label, expect):
    """The dense and paged main calls' tokens: equal on every greedy row."""
    greedy = [i for i, p in enumerate(params) if p.temperature <= 0]
    eq = [i for i in range(len(params)) if first[i].tokens == pfirst[i].tokens]
    print(f"{label}: dense and paged tokens equal on {len([i for i in greedy if i in eq])} of "
          f"{len(greedy)} greedy rows, {len(eq)} of {len(params)} rows in all")
    expect(all(i in eq for i in greedy), f"{label}: dense and paged greedy tokens differ")


def whisper_phase(torch, counters, card):
    """Whisper-medium at full size (bf16, seeded random weights; 1 500
    precomputed frames of the audio stub): ``LLM.generate`` with one audio
    for every request (``extra_batch``, re-encoded at each admission) on 32
    slots of Whisper's 448-token decoder context, 64 prompts of 4-64
    tokens, 32 new, half greedy; dense, then paged (pages of 16; the prefix
    cache and chunked prefill are refused for it), each held to the plain
    route; then ``launch.serve.generate`` with 32 distinct audios, the load
    where each request has its own.  Returns each run's launch counts."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.model import Model, build_model

    failed = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    cfg = dataclasses.replace(get_config("whisper-medium"), param_dtype="bfloat16")
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"built {cfg.name} ({cfg.encoder_layers} encoder + {cfg.num_layers} decoder layers, "
          f"d_model {cfg.d_model}, {cfg.num_heads} heads of {cfg.head_dim}, vocab {cfg.vocab_size} "
          f"padded to {cfg.padded_vocab}, {n_params / 1e9:.3f}B params with the two position "
          f"tables, bf16) in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    g = torch.Generator(device=model.device).manual_seed(11)
    T = cfg.num_frontend_tokens
    audio = torch.randn(1, T, cfg.d_model, generator=g, device=model.device)
    slots, max_len, n, new = 32, 448, 64, 32
    lengths, prompts, params = generation_load(np, cfg.vocab_size, n, new, seed=5, lo=4, hi=64)
    dense_kw = dict(slots=slots, max_len=max_len, extra_batch={"enc_embeds": audio})
    paged_kw = dict(dense_kw, cache_layout="paged", page_size=16)
    out = {}
    out["whisper_dense"], first = zoo_generate(torch, counters, card, model, "whisper-medium dense",
                                               dense_kw, (prompts, params), expect,
                                               frontend_want(cfg, False))
    gc.collect()
    torch.cuda.empty_cache()
    out["whisper_paged"], pfirst = zoo_generate(torch, counters, card, model, "whisper-medium paged",
                                                paged_kw, (prompts, params), expect,
                                                frontend_want(cfg, True))
    gc.collect()
    torch.cuda.empty_cache()
    same_greedy(first, pfirst, params, "whisper-medium", expect)
    plain = Model(dataclasses.replace(cfg, kernel_impl="torch"), model.params.tree())
    for layout, kw, f in (("dense", dense_kw, first), ("paged", paged_kw, pfirst)):
        frontend_routes(torch, np, model, plain, kw, prompts, f,
                        f"whisper-medium kernel route vs plain route, {layout} cache", expect)
        gc.collect()
        torch.cuda.empty_cache()

    # ---- launch.serve.generate: an audio a row
    audios = torch.randn(slots, T, cfg.d_model, generator=g, device=model.device)
    rng = np.random.default_rng(8)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(slots, 16)).astype(np.int32),
             "enc_embeds": audios}
    L, E = cfg.num_layers, cfg.encoder_layers
    # the static loop samples `new` tokens (the first from the prefill's
    # logits) and runs `new` decode steps
    want = dict(frontend_want(cfg, False)(1, 0, new), fused_sample=new)
    zero_launches(counters)
    counters["paged_decode"].appends = 0
    t0 = time.perf_counter()
    toks, tok_s = launch_serve.generate(model, None, batch, max_len=16 + new, steps=new)
    wall = time.perf_counter() - t0
    got = {k: counters[k].launches for k in ZOO_KERNELS}
    got["paged_decode.appends"] = counters["paged_decode"].appends
    print(f"whisper-medium main path: launch.serve.generate of {slots} distinct audios ({slots}, "
          f"{T}, {cfg.d_model}), prompts of 16, {new} new, greedy, on {card}: {tok_s:.0f} generated "
          f"tokens/s over the decode loop ({wall:.3f} s with the prefill); launches {got} (want "
          f"{want})")
    expect(got == want, "whisper-medium static generate: launch counts")
    expect(toks.shape == (slots, new) and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
           "whisper-medium static generate: tokens out of the vocab")
    out["whisper_static"] = got
    dev_batch = {k: torch.as_tensor(v, device=model.device) for k, v in batch.items()}
    cache = forced_route(torch, model, plain, dev_batch, 16 + new, toks[:, :8],
                         "whisper-medium kernel route vs plain route, an audio a row", expect)
    static_decode_profile(torch, model, cache, toks[:, 8:], card, "whisper-medium static")
    del plain, cache, model, audios
    gc.collect()
    torch.cuda.empty_cache()
    check(not failed, "whisper-medium phase: " + "; ".join(failed))
    return out


def internvl2_phase(torch, counters, card, depth):
    """InternVL2-26B at full width with ``depth`` of its 48 layers (bf16,
    seeded random weights; 256 precomputed patch rows of the vision stub):
    the build's peak memory, then ``LLM.generate`` with one image for every
    request (``extra_batch``: its projected rows in front of each prompt)
    on 32 slots, 32 prompts of 64-1 024 tokens, 64 new, half greedy; dense,
    then paged (pages of 16), each held to the plain route; then one
    text-only engine (no image rows).  Returns each run's launch counts."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, build_model

    failed = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    full = get_config("internvl2-26b")
    cfg = dataclasses.replace(full, num_layers=depth, param_dtype="bfloat16")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    print(f"built {cfg.name} at {depth} of {full.num_layers} layers, full width (d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size} padded to {cfg.padded_vocab}, "
          f"{cfg.param_count() / 1e9:.2f}B params + the projector, bf16) in {build_s:.1f} s: "
          f"{(torch.cuda.memory_allocated() - base) / 1e9:.2f} GB of weights, build peak "
          f"{build_peak:.2f} GB")
    g = torch.Generator(device=model.device).manual_seed(12)
    n_img = cfg.num_frontend_tokens
    img = torch.randn(1, n_img, cfg.d_model, generator=g, device=model.device)
    slots, n, new = 32, 32, 64
    lengths, prompts, params = generation_load(np, cfg.vocab_size, n, new, seed=6)
    dense_kw = dict(slots=slots, max_len=n_img + 1024 + new, extra_batch={"img_embeds": img})
    paged_kw = dict(dense_kw, cache_layout="paged", page_size=16)
    out = {}
    out["internvl2_dense"], first = zoo_generate(torch, counters, card, model,
                                                 f"internvl2-26b ({depth} layers) dense", dense_kw,
                                                 (prompts, params), expect,
                                                 frontend_want(cfg, False))
    gc.collect()
    torch.cuda.empty_cache()
    out["internvl2_paged"], pfirst = zoo_generate(torch, counters, card, model,
                                                  f"internvl2-26b ({depth} layers) paged", paged_kw,
                                                  (prompts, params), expect,
                                                  frontend_want(cfg, True))
    gc.collect()
    torch.cuda.empty_cache()
    same_greedy(first, pfirst, params, "internvl2-26b", expect)
    plain = Model(dataclasses.replace(cfg, kernel_impl="torch"), model.params.tree())
    for layout, kw, f in (("dense", dense_kw, first), ("paged", paged_kw, pfirst)):
        frontend_routes(torch, np, model, plain, kw, prompts, f,
                        f"internvl2-26b kernel route vs plain route, {layout} cache", expect)
        gc.collect()
        torch.cuda.empty_cache()
    del plain
    text_kw = dict(slots=slots, max_len=1024 + new)
    out["internvl2_text"], _ = zoo_generate(torch, counters, card, model,
                                            f"internvl2-26b ({depth} layers) text-only dense",
                                            text_kw, (prompts, params), expect)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    check(not failed, "internvl2-26b phase: " + "; ".join(failed))
    return out, build_peak


def main() -> int:
    clock = Clock()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU", file=sys.stderr)
        return 2
    clock.mark("1 imports and card")

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
    from repro_torch.kernels.rmsnorm import layernorm, layernorm_bwd, rmsnorm
    from repro_torch.kernels.sampling import fused_sample
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
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
    # together
    clock.mark("2 build")
    t0 = time.perf_counter()
    logs = _build.finish_builds(_build.start_builds(
        ["flash_attention_fwd", "flash_attention_bwd", "cross_entropy", "flash_decode", "sampling",
         "paged_attention", "grouped_matmul", "ssd_scan", "ssd_scan_bwd", "rmsnorm", "layernorm"]))
    t_nvcc = time.perf_counter() - t0
    for name, log in logs.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill stores" in ln
                and not ln.strip().startswith("0 bytes")]
        print(f"built {name} in {t_nvcc:.1f} s: " + " | ".join(regs))

    # ---- 3. each kernel against its plain version, on the card
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=g, device=dev) * scale + shift).to(dtype)

    clock.mark("3 check_attention_fwd")
    fa_rec = check_attention_fwd(torch, F, ref, flash_attention_fwd, randn, card)
    gc.collect()
    torch.cuda.empty_cache()

    clock.mark("3 check_layernorm")
    ln_rec = check_layernorm(torch, F, ref, layernorm, randn, card)
    clock.mark("3 check_layernorm_bwd")
    ln_bwd_rec = check_layernorm_bwd(torch, F, ref, layernorm_bwd, randn, card)
    gc.collect()
    torch.cuda.empty_cache()

    clock.mark("3 check_attention_bwd")
    fa_bwd_rec = check_attention_bwd(torch, F, ref, flash_attention_fwd, flash_attention_bwd,
                                     randn, card)
    clock.mark("3 check_cross_entropy")
    ce_recs = check_cross_entropy(torch, F, ref, cross_entropy_fwd, cross_entropy_bwd, randn, g, card)
    clock.mark("3 check_rmsnorm")
    gen_recs = [check_rmsnorm(torch, F, ref, rmsnorm, randn, card)]
    clock.mark("3 check_sampling")
    gen_recs.append(check_sampling(torch, ref, fused_sample, randn, card))
    clock.mark("3 check_flash_decode")
    gen_recs.append(check_flash_decode(torch, F, ref, flash_decode, randn, card))
    clock.mark("3 check_paged_decode")
    paged_recs = [check_paged_decode(torch, F, ref, paged_decode, flash_decode, randn, card)]
    clock.mark("3 check_paged_prefill")
    paged_recs.append(check_paged_prefill(torch, F, ref, paged_prefill, flash_attention_fwd,
                                          randn, card))
    clock.mark("3 check_paged_kv_write")
    paged_recs.append(check_paged_kv_write(torch, ref, paged_kv_write, paged_decode, flash_decode,
                                           randn, card))
    clock.mark("3 check_gmm")
    gmm_rec = check_gmm(torch, ref, gmm, card)
    clock.mark("3 check_gmm_dw")
    gmm_dw_rec, gmm_dx_rec = check_gmm_dw(torch, ref, gmm, gmm_dw, card)
    clock.mark("3 check_ssd_scan")
    ssd_rec = check_ssd_scan(torch, ref, ssd_scan, card)
    clock.mark("3 check_ssd_scan_bwd")
    ssd_bwd_rec = check_ssd_scan_bwd(torch, ref, ssd_scan, ssd_scan_bwd, card)
    gc.collect()
    torch.cuda.empty_cache()

    clock.mark("4 esm2 embed")
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
    layernorm.launches = layernorm_bwd.launches = 0
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
    check(layernorm_bwd.launches == 0, "a LayerNorm backward launched on the embedding path")

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

    clock.mark("5 esm2 embed profile")
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

    clock.mark("6 esm2 train")
    # ---- 6. slice 2: ESM-2 650M MLM pre-training through Trainer.run
    counters = {"flash_attention_fwd": flash_attention_fwd, "flash_attention_bwd": flash_attention_bwd,
                "layernorm": layernorm, "layernorm_bwd": layernorm_bwd,
                "cross_entropy_fwd": cross_entropy_fwd,
                "cross_entropy_bwd": cross_entropy_bwd}
    train_launches, full_step, remat = train_phase(torch, model, counters, card)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 6b. slice 3: LoRA fine-tuning of the model just trained (its
    # trainer and moments dropped), then the training data plane, a resume
    # through it and the launcher
    clock.mark("6b lora")
    phase_launches = {"train": train_launches}
    phase_launches["lora"] = lora_phase(torch, model, counters, card, full_step)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    clock.mark("6b data plane")
    phase_launches["data_plane"], phase_launches["data_plane_cluster"], dp_shapes = \
        data_plane_phase(torch, counters, card)
    gc.collect()
    torch.cuda.empty_cache()
    clock.mark("6b resume")
    phase_launches["resume"], resume_shapes = resume_phase(torch, counters, card)
    gc.collect()
    torch.cuda.empty_cache()
    clock.mark("6b launcher")
    phase_launches["launcher"], launcher_shapes = launcher_phase(torch, counters, card)
    gc.collect()
    torch.cuda.empty_cache()
    clock.mark("6b bucket kernels")
    # the kernels at every (B, L) those three phases trained on
    bucket_shapes = dp_shapes | resume_shapes | launcher_shapes
    print(f"bucket shapes to check: {len(bucket_shapes)} (data plane {len(dp_shapes)}, resume "
          f"{len(resume_shapes)}, launcher {len(launcher_shapes)})")
    check_bucket_kernels(torch, ref, counters, bucket_shapes, randn, get_config("esm2-650m"))

    clock.mark("6c mesh train")
    # ---- 6c. slice 8's training half: the sharded Trainer on a (1, 1) mesh
    # over NCCL against the mesh-free run, then the launcher under torchrun
    phase_launches["mesh_train"], mesh_figures = mesh_train_phase(torch, counters, card)
    gc.collect()
    torch.cuda.empty_cache()

    clock.mark("7 qwen2 dense")
    # ---- 7. slice 4a: Qwen2-7B generation through LLM.generate; the
    # paths from here to the MoE training phase run RMSNorm, no LayerNorm
    layernorm.launches = layernorm_bwd.launches = 0
    counters.update(rmsnorm=rmsnorm, flash_decode=flash_decode, fused_sample=fused_sample)
    gen_launches, model = generate_phase(torch, counters, card)
    gc.collect()
    torch.cuda.empty_cache()

    clock.mark("8 qwen2 paged")
    # ---- 8. slice 4b: the same model and load through the paged KV cache
    counters.update(paged_decode=paged_decode, paged_prefill=paged_prefill,
                    paged_kv_write=paged_kv_write)
    paged_launches = paged_phase(torch, counters, card, model)
    gc.collect()
    torch.cuda.empty_cache()

    clock.mark("8b mesh serve")
    # ---- 8b. slice 8's serving half: the engine on a (1, 1) mesh over NCCL
    # against the mesh-free engine on the same model's seed, ESM-2's
    # embeddings on the mesh, the serving launcher under torchrun, then two
    # head-TP ranks on the one card over Gloo
    mesh_serve_launches, mesh_serve_figures = mesh_serve_phase(torch, counters, card, model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    clock.mark("8b mesh serve launcher")
    mesh_serve_figures["launcher_s"] = mesh_serve_launch(card)
    clock.mark("8b mesh serve tp2")
    tp2 = mesh_serve_tp2_phase(torch, counters, card)
    gc.collect()
    torch.cuda.empty_cache()

    clock.mark("9 scout generate")
    # ---- 9. slice 5: Llama-4-Scout (8 of 48 layers) MoE generation
    counters.update(gmm=gmm)
    moe_launches = moe_phase(torch, counters, card)
    gc.collect()
    torch.cuda.empty_cache()

    clock.mark("10 mamba2 generate")
    # ---- 10. slice 6: Mamba2-2.7B generation, then the hybrid unit (reduced Jamba)
    counters.update(ssd_scan=ssd_scan)
    ssm_launches = ssm_phase(torch, counters, card)
    gc.collect()
    torch.cuda.empty_cache()
    clock.mark("10 jamba generate")
    hybrid_phase(torch, counters, card)
    gc.collect()
    torch.cuda.empty_cache()

    clock.mark("11 scout train")
    # ---- 11. slice 5b: Llama-4-Scout (1 of 48 layers) MoE training
    counters.update(gmm_dw=gmm_dw)
    moe_train_launches = moe_train_phase(torch, counters, card)
    print(f"LayerNorm launches on the RMSNorm paths (Qwen2, Scout, Mamba2, reduced Jamba "
          f"generation, Scout training): forward {layernorm.launches}, backward "
          f"{layernorm_bwd.launches} (want 0)")
    check(layernorm.launches == layernorm_bwd.launches == 0,
          "a LayerNorm launched on an RMSNorm path")
    gc.collect()
    torch.cuda.empty_cache()

    clock.mark("12 mamba2 train")
    # ---- 12. the SSM training path: Mamba2-2.7B at full width and depth,
    # reduced Jamba, and the launcher on Mamba2
    counters.update(ssd_scan_bwd=ssd_scan_bwd)
    ssm_train, ssm_peak_gb = ssm_train_phase(torch, counters, card)
    gc.collect()
    torch.cuda.empty_cache()
    clock.mark("12 jamba train")
    hybrid_train = hybrid_train_phase(torch, counters, card)
    gc.collect()
    torch.cuda.empty_cache()
    clock.mark("12 mamba2 launcher")
    ssm_launcher, _ = ssm_launcher_phase(torch, counters, card)
    gc.collect()
    torch.cuda.empty_cache()

    clock.mark("13 geneformer")
    # ---- 13. the rest of the zoo: Geneformer-106M embedded and trained at
    # full size, then Command-R-35B (dense and paged), Qwen1.5-32B and
    # Llama-3-405B generating at full width with their depth cut
    gene = geneformer_phase(torch, counters, card)
    gc.collect()
    torch.cuda.empty_cache()
    zoo = {}
    for name, depth in ZOO_DECODERS:
        clock.mark(f"13 {name}")
        zoo[name] = zoo_decoder_phase(torch, counters, card, name, depth)
        gc.collect()
        torch.cuda.empty_cache()

    # ---- 14. slice 7: MolMIM-65M trained and generating through
    # launch.serve.generate, Whisper-medium served with one audio for every
    # request and with an audio a row, InternVL2-26B at full width with an
    # image and text-only
    slice7 = {}
    for name, phase in (("molmim", molmim_phase), ("whisper", whisper_phase),
                        ("internvl2", lambda *a: internvl2_phase(*a, INTERNVL2_DEPTH)[0])):
        clock.mark(f"14 {name}")
        slice7.update(phase(torch, counters, card))
        gc.collect()
        torch.cuda.empty_cache()

    # launches: each kernel's count in the run of its path — the training
    # run for rows 1-5 and LayerNorm's backward (the embed and generation
    # runs' counts of the attention forward were checked in phases 4 and
    # 7), the dense
    # generation run for rows 6-8, the paged one for rows 9-11, the MoE one
    # for row 12, the MoE training one for row 13, the Mamba2 one for row 14
    kernels = [
        fa_rec,
        fa_bwd_rec,
        *ce_recs,
        ln_rec,
        ln_bwd_rec,
    ]
    for rec in kernels:
        rec["launches"] = train_launches[rec["name"]]
        rec["launches_by_phase"] = {ph: n[rec["name"]] for ph, n in phase_launches.items()}
    for rec in gen_recs:
        rec["launches"] = gen_launches[rec["name"]]
    for rec in paged_recs:
        rec["launches"] = paged_launches[rec["name"]]
    # row 11's insert runs inside paged_decode's launches on the main path
    ins = paged_recs[2]
    ins["standalone_launches"] = ins["launches"]
    ins["launches"] = ins["fused"]["launches"] = paged_launches["paged_decode.appends"]
    gmm_rec["launches"] = moe_launches["gmm"]
    gmm_dw_rec["launches"] = moe_train_launches["gmm_dw"]
    gmm_dx_rec["launches"] = moe_train_launches["gmm dx"]
    gmm_rec["dx"] = gmm_dx_rec          # row 12's transposed mode, from the training run
    for rec in ce_recs:       # Scout's numbers with the Scout training run's count
        rec["scout"]["launches"] = moe_train_launches[rec["name"]]
    ssd_rec["launches"] = ssm_launches["ssd_scan"]
    # the SSD pair's counts on the training path (row 14's forward and the
    # port's own backward, whose main path is Mamba2's training run)
    ssd_phases = {"mamba2_train": ssm_train, "jamba_train": hybrid_train,
                  "mamba2_launcher": ssm_launcher}
    ssd_rec["launches_train"] = ssm_train["ssd_scan"]
    ssd_rec["launches_by_phase"] = {"mamba2_generate": ssm_launches["ssd_scan"],
                                    **{ph: n["ssd_scan"] for ph, n in ssd_phases.items()}}
    ssd_bwd_rec["launches"] = ssm_train["ssd_scan_bwd"]
    ssd_bwd_rec["launches_by_phase"] = {ph: n["ssd_scan_bwd"] for ph, n in ssd_phases.items()}
    ssd_bwd_rec["train_peak_gb"] = ssm_peak_gb
    # rows 1-11 on the zoo's and slice 7's paths: each kernel's count in each run
    zoo_runs = {"geneformer_embed": gene["embed"], "geneformer_train": gene["train"],
                **{f"{name}_{layout}": n for name, runs in zoo.items()
                   for layout, n in runs.items()}, **slice7,
                **{f"mesh_serve_{k}": n for k, n in mesh_serve_launches.items()},
                **{f"mesh_tp2_rank{r}_{layout}": n for r, runs in enumerate(tp2["launches"])
                   for layout, n in runs.items()}}
    for rec in kernels + gen_recs + paged_recs:
        key = "paged_decode.appends" if rec is ins else rec["name"]
        rec.setdefault("launches_by_phase", {}).update(
            {ph: n[key] for ph, n in zoo_runs.items() if n.get(key)})
    kernels += gen_recs + paged_recs + [gmm_rec, gmm_dw_rec, ssd_rec, ssd_bwd_rec]
    clock.mark()
    print(f"chip_smoke.py took {clock.total():.1f} s on {card}")
    print(json.dumps({"phases": clock.phases, "total_s": round(clock.total(), 1),
                      "remat_esm2": {p: dict(zip(("loss", "digest", "wall_ms", "device_ms",
                                                  "peak_gb", "peak_above_start_gb"), v))
                                     for p, v in remat.items()},
                      "mamba2_train_peak_gb": ssm_peak_gb, "mesh_train_esm2": mesh_figures,
                      "mesh_serve_qwen2": mesh_serve_figures,
                      "mesh_tp2_qwen2": {k: v for k, v in tp2.items() if k != "launches"}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp2-rank"]:       # a rank of mesh_serve_tp2_phase
        tp2_child(int(sys.argv[2]), sys.argv[3])
        sys.exit(0)
    sys.exit(main())
