#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's kernels from the sources in this checkout, holds each
kernel against its plain PyTorch version on the card, then serves ESM-2
650M embeddings end to end (full width and depth, seeded random weights)
through ``LLM.embed`` and checks what comes out.  Prints per-kernel times
beside their bounds and the embedding throughput, then one JSON line of
kernel records and, last, ``{"ok": true, "device": {...}}``.  Exits non-zero,
printing no result, when there is no CUDA device or a phase fails.
Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
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


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


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
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.rmsnorm import layernorm
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
    logs = _build.finish_builds(_build.start_builds(["flash_attention_fwd"]))
    t_nvcc = time.perf_counter() - t0
    for name, log in logs.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"built {name} in {t_nvcc:.1f} s: " + " | ".join(regs))
    t0 = time.perf_counter()
    xw = torch.ones(8, 1280, device=dev, dtype=torch.bfloat16)
    layernorm(xw, torch.ones(1280, device=dev), torch.zeros(1280, device=dev))
    torch.cuda.synchronize()
    print(f"compiled layernorm (Triton) in {time.perf_counter() - t0:.1f} s")

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
    fa_plain_ms = time_ms(torch, lambda: ref.attention_ref(q, k, v, causal=False))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    fa_lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt))
    fa_flops = 4 * B * H * S * S * D
    fa_bytes = 4 * B * S * H * D * 2 + B * H * S * 4
    fa_bound_ms = max(fa_flops / PEAK_BF16_FLOPS, fa_bytes / PEAK_BYTES_PER_S) * 1e3
    fa_bound_by = "operations" if fa_flops / PEAK_BF16_FLOPS >= fa_bytes / PEAK_BYTES_PER_S else "bytes"
    print(f"flash_attention_fwd B={B} S=T={S} H={H} D={D} bf16 on {card}: {fa_ms:.4f} ms "
          f"(bound {fa_bound_ms:.4f} ms by {fa_bound_by}, {fa_flops / fa_ms / 1e9:.1f} TFLOP/s), "
          f"plain {fa_plain_ms:.4f} ms, scaled_dot_product_attention {fa_lib_ms:.4f} ms")

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
    ln_plain_ms = time_ms(torch, lambda: ref.layernorm_ref(x, w, b))
    ln_lib_ms = time_ms(torch, lambda: F.layer_norm(x, (d,), wl, bl, 1e-5))
    ln_bytes = 2 * rows * d * 2 + 2 * d * 4
    ln_flops = 8 * rows * d
    ln_bound_ms = max(ln_bytes / PEAK_BYTES_PER_S, ln_flops / PEAK_FP32_FLOPS) * 1e3
    ln_bound_by = "bytes" if ln_bytes / PEAK_BYTES_PER_S >= ln_flops / PEAK_FP32_FLOPS else "operations"
    print(f"layernorm ({rows}, {d}) bf16 on {card}: {ln_ms:.4f} ms (bound {ln_bound_ms:.4f} ms by {ln_bound_by}, "
          f"{ln_bytes / ln_ms / 1e6:.0f} GB/s), plain {ln_plain_ms:.4f} ms, F.layer_norm {ln_lib_ms:.4f} ms")

    # ---- 4. the slice: ESM-2 650M embedding serving through LLM.embed
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

    real_tokens = int(lengths.sum())
    padded_tokens = 32 * sum(buckets)
    print(f"ESM-2 650M LLM.embed on {card}: {n / t_steady:.1f} sequences/s, "
          f"{real_tokens / t_steady:.0f} tokens/s ({padded_tokens / t_steady:.0f} padded tokens/s; "
          f"{n} sequences, {real_tokens} tokens, {t_steady:.3f} s; first call {t_first:.3f} s)")

    # ---- 5. where the time goes: one more embed call under the profiler
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        llm.embed(prompts)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side entries only (CPU ops report their kernels' time too);
    # "Command Buffer Full" marks the host waiting on a full launch queue
    kern = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and "Command Buffer Full" not in e.key]
    busy_ms = sum(t for _, t, _ in kern)
    if busy_ms == 0:
        print("profile: the profiler saw no device time")
    else:
        groups = {"flash_attention_fwd": 0.0, "layernorm": 0.0, "matmul": 0.0, "other": 0.0}
        for name, t, _ in kern:
            low = name.lower()
            if "flash_attention_fwd" in low:
                groups["flash_attention_fwd"] += t
            elif "layernorm" in low:
                groups["layernorm"] += t
            elif any(w in low for w in ("gemm", "xmma", "cutlass", "nvjet")):
                groups["matmul"] += t
            else:
                groups["other"] += t
        print(f"profile of one embed call on {card}: wall {wall_ms:.1f} ms (under the profiler), "
              f"device busy {busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
        print("profile by group: " + ", ".join(
            f"{k} {v:.1f} ms ({v / busy_ms:.1%})" for k, v in groups.items()))
        for name, t, cnt in sorted(kern, key=lambda r: -r[1])[:12]:
            print(f"  {t:9.2f} ms {cnt:6d}x  {name[:110]}")

    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
         "replaces": "src/repro/kernels/flash_attention.py:211",
         "launches": launches["flash_attention_fwd"], "max_abs_err": fa_serving_err,
         "ms": fa_ms, "plain_ms": fa_plain_ms, "bound_ms": fa_bound_ms,
         "bound_by": fa_bound_by, "library_ms": fa_lib_ms},
        {"name": "layernorm", "route": "triton",
         "source": "src/repro_torch/kernels/rmsnorm.py",
         "replaces": "src/repro/kernels/rmsnorm.py:83",
         "launches": launches["layernorm"], "max_abs_err": ln_serving_err,
         "ms": ln_ms, "plain_ms": ln_plain_ms, "bound_ms": ln_bound_ms,
         "bound_by": ln_bound_by, "library_ms": ln_lib_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
