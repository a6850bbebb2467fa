#!/usr/bin/env python3
"""Time the decode step's flash-decoding and RMSNorm kernels against the
parent's, and flash-decoding against variants of its design, at
Qwen2-7B's and Llama-4-Scout's decode shapes.

    python3 decode_variants.py --save-parent REV   # in a git checkout
    python3 decode_variants.py [--parent [DIR]]     # on one card

``--save-parent REV`` writes ``git show REV:`` of ``csrc/flash_decode.cu``,
``csrc/mma.cuh`` and ``kernels/rmsnorm.py`` into DIR (by default
``.chip_archive/parent/``: ignored by git, skipped by pytest, carried by a
copy of the tree) and stops.  On the card, ``--parent`` adds that
``flash_decode.cu`` (built with its own header beside it, which is found
before the tree's) and that ``rmsnorm.py`` (a module of its own; before
the CUDA RMSNorm its kernel is Triton).

Needs one card.  Each variant is a textual edit of ``csrc/flash_decode.cu``
built into its own library under ``kernels/build/variants/`` (the source
in the tree is not changed), one nvcc each, all started together:

- "ring 1 stage", "ring 3 stages", "ring 4 stages": each warp's ring of
  16-key K/V stages that deep (the tree: 2);
- "2 warps a block", "8 warps a block" (the tree: 4);
- "4 blocks an SM": the split kernel's registers capped for 4 resident
  blocks;
- "chunk 512": 512-key splits (the tree: 256).

and of ``csrc/rmsnorm.cu``:

- "128 threads of 4 vectors": blocks of at most 128 threads, each holding
  up to four 8-element vectors of the row (the tree: a thread a vector,
  up to 1024 threads).

For every flash-decoding library, in the order parent, tree, variants and
then back, each decode shape (ragged lengths from ``chip_smoke``'s seeded
draw) is timed: CUDA events over back-to-back calls and the profiler's
device time (``chip_smoke.device_ms``), beside the bound, SDPA with a
length mask and GQA, each library's row error against the plain version
and whether its output equals the tree's bit for bit; the tree's device
time is also split between its two kernels.  RMSNorm, the
parent's, the tree's and the variant's (where the width fits it) in turns
at (32, 3584), (32, 5120) and (2048,
3584) bf16: back to back, device time on one input and over inputs
rotated past the 50 MB L2, ``F.rms_norm`` beside them; then the host's
cost of the tree's wrapper and its parts (µs a call over back-to-back
calls).  Writes the readings to ``chiprun_out/decode_variants.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import chip_smoke as cs

PARENT_FILES = {"flash_decode.cu": "src/repro_torch/kernels/csrc/flash_decode.cu",
                "mma.cuh": "src/repro_torch/kernels/csrc/mma.cuh",
                "rmsnorm.py": "src/repro_torch/kernels/rmsnorm.py"}
PARENT_DIR = cs.ROOT / ".chip_archive" / "parent"
VARIANTS = {
    "ring 1 stage": [("constexpr int kStages = 2;", "constexpr int kStages = 1;")],
    "ring 3 stages": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    "ring 4 stages": [("constexpr int kStages = 2;", "constexpr int kStages = 4;")],
    "2 warps a block": [("constexpr int kWarps = 4;", "constexpr int kWarps = 2;")],
    "8 warps a block": [("constexpr int kWarps = 4;", "constexpr int kWarps = 8;")],
    "4 blocks an SM": [("__launch_bounds__(kThreads) flash_decode_split_kernel",
                        "__launch_bounds__(kThreads, 4) flash_decode_split_kernel")],
    "chunk 512": [("constexpr int kChunk = 256;", "constexpr int kChunk = 512;")],
}
NORM_VARIANTS = {
    "128 threads of 4 vectors": [("constexpr int kMaxThreads = 1024;", "constexpr int kMaxThreads = 128;"),
                                 ("constexpr int kMaxVpt = 2;", "constexpr int kMaxVpt = 4;")],
}


def save_parent(rev: str, out: Path) -> None:
    out.mkdir(parents=True, exist_ok=True)
    for name, path in PARENT_FILES.items():
        text = subprocess.run(["git", "show", f"{rev}:{path}"], cwd=cs.ROOT, capture_output=True,
                              text=True, check=True).stdout
        (out / name).write_text(text)
    print(f"wrote {rev}'s {', '.join(PARENT_FILES)} into {out}")


def build(src_name, variants, parent=None):
    """One nvcc per variant of ``csrc/<src_name>.cu`` (and the parent's
    source), all started together -> {name: running job}; ``finish``
    waits for them."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / f"{src_name}.cu").read_text()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {}
    for i, (name, edits) in enumerate(variants.items()):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: {old!r} is not in the source once")
            text = text.replace(old, new)
        cu = out_dir / f"{src_name}_variant{i}.cu"
        cu.write_text(text)
        sources[name] = cu
    if parent:
        sources["parent"] = parent
    jobs = {}
    for i, (name, cu) in enumerate(sources.items()):
        so = out_dir / f"{src_name}_variant{i}.so"
        cmd = [_build.nvcc(), *_build.FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True))
    return jobs


def finish(jobs):
    """{name: library path} of the jobs of ``build`` that built."""
    built = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:   # a variant that does not build is reported and left out
            print(f"variant {name!r} did not build:\n{log}")
            if name == "parent":
                raise RuntimeError("the parent's source did not build")
        else:
            built[name] = so
    return built


def per_call_us(torch, fn, n: int = 2000) -> float:
    """Host µs a call over ``n`` back-to-back calls (the device keeps up)."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--save-parent", metavar="REV", default="")
    ap.add_argument("--parent", nargs="?", const=str(PARENT_DIR), default="", metavar="DIR")
    args = ap.parse_args()
    if args.save_parent:
        save_parent(args.save_parent, Path(args.parent or PARENT_DIR))
        return 0

    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("decode_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import rmsnorm as rn

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    parent = Path(args.parent).resolve() if args.parent else None
    jobs = _build.start_builds(["flash_decode", "rmsnorm"])
    fd_jobs = build("flash_decode", VARIANTS, parent and parent / "flash_decode.cu")
    norm_jobs = build("rmsnorm", NORM_VARIANTS)
    libs = {"tree": None, **finish(fd_jobs)}
    norm_libs = finish(norm_jobs)
    _build.finish_builds(jobs)
    libs["tree"] = _build.lib_path("flash_decode")
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fns = {}
    for name, so in libs.items():
        lib = ctypes.CDLL(str(so))
        lib.flash_decode.argtypes = [P] * 8 + [I] * 5 + [I64] * 10 + [ctypes.c_float, P]
        lib.flash_decode_splits.argtypes = [I]
        fns[name] = lib

    def decode(name, q, k, v, lengths):
        lib = fns[name]
        B, _, H, D = q.shape
        T, Hkv = k.shape[1], k.shape[2]
        splits = lib.flash_decode_splits(T)
        out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
        n = B * H * splits
        part = torch.empty((n * (D + 2),), dtype=torch.float32, device=q.device)
        base = part.data_ptr()
        err = lib.flash_decode(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                               out.data_ptr(), base, base + 4 * n, base + 8 * n, B, T, H, Hkv, D,
                               q.stride(0), q.stride(2), *k.stride()[:3], *v.stride()[:3],
                               out.stride(0), out.stride(2), 0.0,
                               torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: flash_decode launch failed ({err})")
        return out

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    readings = {"card": card}
    order = ["parent"] * bool(parent) + ["tree"] + [n for n in VARIANTS if n in fns]

    # flash-decoding at the decode shapes, lengths as chip_smoke draws them
    rng = np.random.default_rng(1)
    for label, (B, T, H, Hkv, D) in {"qwen2-7b": (32, 2048, 28, 4, 128),
                                     "scout": (32, 2048, 40, 8, 128)}.items():
        lens = rng.integers(0, T + 1, size=B)
        lens[:3] = [0, 1, T]
        lengths = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        q, k, v = (torch.randn(s, generator=g, device=dev).bfloat16()
                   for s in ((B, 1, H, D), (B, T, Hkv, D), (B, T, Hkv, D)))
        fd.check_args(q, k, v, lengths)
        live = int(lens.sum())
        nbytes = 2 * B * H * D * 2 + 2 * live * Hkv * D * 2 + B * 4
        bound_ms, bound_by = cs.bound(4 * H * D * live, nbytes)
        want = ref.decode_attention_ref(q, k, v, lengths)
        tree_out = decode("tree", q, k, v, lengths)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        mask = (torch.arange(T, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
        lib_ms = cs.time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True))
        times = {name: [] for name in order}
        for name in order + order[::-1]:
            times[name].append((cs.time_ms(torch, lambda: decode(name, q, k, v, lengths)),
                                cs.device_ms(torch, lambda: decode(name, q, k, v, lengths),
                                             "flash_decode", floor=bound_ms)))
        print(f"---- flash_decode at {label}'s decode shape (B={B}, T={T}, H={H}, Hkv={Hkv}, D={D}, "
              f"{live} live rows) on {card}: bound {bound_ms:.4f} ms by {bound_by}; SDPA (length "
              f"mask, GQA) {lib_ms:.4f} ms")
        for name in order:
            out = decode(name, q, k, v, lengths)
            ms = sum(t[0] for t in times[name]) / 2
            devs = [t[1] for t in times[name] if t[1]]
            dev_ms = sum(devs) / len(devs) if devs else None
            r = {"ms": ms, "device_ms": dev_ms, "runs": times[name], "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": lib_ms,
                 "row_err": cs.row_rel_err(out, want), "bit_identical_to_tree": torch.equal(out, tree_out)}
            readings.setdefault(name, {})[f"flash_decode {label}"] = r
            print(f"{name}: {ms:.4f} ms back to back, device {cs.fmt_ms(dev_ms)} ms "
                  f"({cs.per_device_ms(nbytes, dev_ms, 'GB/s', 1e6)}), runs {times[name]}, row err "
                  f"{r['row_err']:.3g}, bit-identical to the tree: {r['bit_identical_to_tree']}")
        split = cs.device_ms_by_kernel(torch, lambda: decode("tree", q, k, v, lengths),
                                       ("split", "combine"))
        readings["tree"][f"flash_decode {label}"]["device_ms_by_kernel"] = split
        print(f"tree's device ms by kernel: {split}")
        del q, k, v, kt, vt

    # RMSNorm: the parent's wrapper and kernel and the variants' kernels
    # (called through ctypes) against the tree's
    norms = {"tree": rn.rmsnorm}
    if parent:
        spec = importlib.util.spec_from_file_location("parent_rmsnorm", parent / "rmsnorm.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        norms = {"parent": mod.rmsnorm, **norms}

    def norm_variant(lib):
        lib.rmsnorm.argtypes = [P, P, P, I, I, I64, I, ctypes.c_float, P]

        def call(x, w):
            y = torch.empty_like(x)
            err = lib.rmsnorm(x.data_ptr(), w.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1],
                              x.shape[1], 1 | 1 << 2, 1e-5, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"rmsnorm variant launch failed ({err})")
            return y
        call.max_width = lib.rmsnorm_max_width()
        return call

    variants = {name: norm_variant(ctypes.CDLL(str(so))) for name, so in norm_libs.items()}
    for rows, d in ((32, 3584), (32, 5120), (2048, 3584)):
        norms_here = {**norms, **{n: f for n, f in variants.items() if d <= f.max_width},
                      "F.rms_norm": lambda x, w: F.rms_norm(x, (x.shape[-1],), w, 1e-5)}
        x = (torch.randn(rows, d, generator=g, device=dev) * 3 + 0.5).bfloat16()
        w = torch.randn(d, generator=g, device=dev).bfloat16()
        copies = -(-3 * 50 * 2**20 // (rows * d * 2))
        xs = [(torch.randn(rows, d, generator=g, device=dev) * 3 + 0.5).bfloat16() for _ in range(copies)]
        nbytes = 2 * rows * d * 2 + d * 2
        bound_ms, bound_by = cs.bound(4 * rows * d, nbytes, cs.PEAK_FP32_FLOPS)
        want = ref.rmsnorm_ref(x, w)
        tree_out = rn.rmsnorm(x, w)
        lib_ms = cs.time_ms(torch, lambda: F.rms_norm(x, (d,), w, 1e-5))
        times = {name: [] for name in norms_here}
        for name in list(norms_here) + list(norms_here)[::-1]:
            fn = norms_here[name]
            rot = itertools.cycle(xs)
            times[name].append((cs.time_ms(torch, lambda: fn(x, w)),
                                cs.device_ms(torch, lambda: fn(x, w), "rmsnorm", floor=bound_ms),
                                cs.device_ms(torch, lambda: fn(next(rot), w), "rmsnorm",
                                             floor=bound_ms)))
        print(f"---- rmsnorm ({rows}, {d}) bf16 on {card}: bound {bound_ms:.5f} ms by {bound_by}; "
              f"F.rms_norm {lib_ms:.4f} ms")
        for name, fn in norms_here.items():
            out = fn(x, w)
            ms = sum(t[0] for t in times[name]) / 2
            avg = [[t[i] for t in times[name] if t[i]] for i in (1, 2)]
            dev_ms, dram_ms = (sum(a) / len(a) if a else None for a in avg)
            r = {"ms": ms, "device_ms": dev_ms, "device_ms_dram": dram_ms, "runs": times[name],
                 "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
                 "max_err": (out.float() - want.float()).abs().max().item(),
                 "bit_identical_to_tree": torch.equal(out, tree_out)}
            readings.setdefault(name, {})[f"rmsnorm ({rows}, {d})"] = r
            print(f"{name}: {ms:.4f} ms back to back, device {cs.fmt_ms(dev_ms)} ms, over {copies} "
                  f"inputs rotated past L2 {cs.fmt_ms(dram_ms)} ms, runs {times[name]}, max err "
                  f"{r['max_err']:.3g}, bit-identical to the tree: {r['bit_identical_to_tree']}")
        del xs

    # the host's cost of the tree's RMSNorm wrapper and its parts, at the
    # decode shape
    x = (torch.randn(32, 3584, generator=g, device=dev) * 3 + 0.5).bfloat16()
    w = torch.randn(3584, generator=g, device=dev).bfloat16()
    y = torch.empty_like(x)
    fn = rn._rmsnorm_fn()
    xp, wp, yp = x.data_ptr(), w.data_ptr(), y.data_ptr()
    stream = torch._C._cuda_getCurrentRawStream(0)
    parts = {
        "an empty Python call": lambda: None,
        "x.new_empty(shape)": lambda: x.new_empty(x.shape),
        "torch.empty_like(x)": lambda: torch.empty_like(x),
        "torch.empty(shape, dtype, device)": lambda: torch.empty(x.shape, dtype=x.dtype,
                                                                 device=x.device),
        "the raw stream": lambda: torch._C._cuda_getCurrentRawStream(0),
        "the ctypes call and launch alone": lambda: fn(xp, wp, yp, 32, 3584, 3584, 1 | 1 << 2,
                                                       1e-5, stream),
        "rmsnorm (the tree's wrapper)": lambda: rn.rmsnorm(x, w),
        "F.rms_norm": lambda: F.rms_norm(x, (3584,), w, 1e-5),
    }
    if parent:
        parts["rmsnorm (the parent's Triton wrapper)"] = lambda: norms["parent"](x, w)
    host = {name: per_call_us(torch, f) for name, f in parts.items()}
    readings["host µs a call, (32, 3584) bf16"] = host
    print(f"---- host µs a call at (32, 3584) bf16 on {card}: " +
          ", ".join(f"{k} {v:.2f}" for k, v in host.items()))

    out = cs.ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "decode_variants.json").write_text(json.dumps(readings, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
