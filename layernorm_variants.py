#!/usr/bin/env python3
"""Time the LayerNorm kernels against the parent's Triton forward and
against variants of their grids, at the shapes the port's paths run them
at.

    python3 layernorm_variants.py --save-parent REV   # in a git checkout
    python3 layernorm_variants.py [--parent [DIR]]     # on one card

``--save-parent REV`` writes ``git show REV:src/repro_torch/kernels/rmsnorm.py``
into DIR (by default ``.chip_archive/parent/``: ignored by git, skipped by
pytest, carried by a copy of the tree) and stops.  On the card,
``--parent`` loads that file as a module of its own: a parent whose
LayerNorm is the Triton kernel runs it through Triton's launcher (the card's
``triton`` compiles it at its first call).

Needs one card.  Each variant (``VARIANTS``) is a text edit of
``csrc/layernorm.cu``, built under ``kernels/build/variants/`` (one nvcc
each, all started together; the tree is not changed) and called through
its C entry point: the forward with one row a block (the tree: a resident
grid that loops over the rows), with 256 and 1024 threads a block (the
tree: 512), with the registers capped for 3 blocks an SM at two vectors a
thread (d 4096-8192) and for 2 blocks of 1024 threads an SM, the backward
with half and with twice the blocks (the tree: as many as the SMs hold at
once).  ``cuobjdump -res-usage`` on the libraries under
``kernels/build/`` gives each instance's registers.

The forward at the eight shapes of ``chip_smoke.LAYERNORM_TIMED``: the
tree's kernel, its variant, the parent's and ``F.layer_norm``, in turns
(the order and then back, twice): CUDA events over back-to-back calls and
the device time of every kernel a call launches (``chip_smoke.busy_ms``),
beside the bound, whether each output is within
``chip_smoke.layernorm_tol`` of the plain version's and whether it equals
the tree's bit for bit.

The backward at the three training shapes of
``chip_smoke.LAYERNORM_BWD_TIMED``: the tree's kernel pair and its variants
(each with a workspace sized for its grid) in turns, then the plain version
and ``F.layer_norm``'s backward.  A variant's dx must equal the tree's bit
for bit (a row's arithmetic does not depend on the grid); dw and db are
held to the plain version as ``chip_smoke.check_layernorm_bwd`` holds
them.

Then each wrapper's host µs a call at Whisper's decode shape (32, 1024).
Writes the readings to ``chiprun_out/layernorm_variants.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs
import decode_variants as dv

PARENT_FILES = {"rmsnorm.py": "src/repro_torch/kernels/rmsnorm.py"}
PARENT_DIR = cs.ROOT / ".chip_archive" / "parent"
RESIDENT = "constexpr int kBwdResident = 1024;"
FWD_THREADS = "constexpr int kFwdMaxThreads = 512;"
FWD_BOUNDS = "__global__ void __launch_bounds__(kFwdMaxThreads) layernorm_kernel("
# label -> (the pass it changes, text edits of csrc/layernorm.cu)
VARIANTS = {
    "forward, one row a block": ("fwd", [(
        "layernorm.cu", "const int grid = rows < held ? rows : held;", "const int grid = rows;")]),
    "forward, 256 threads a block": ("fwd", [("layernorm.cu", FWD_THREADS, FWD_THREADS.replace(
        "512", "256"))]),
    "forward, 1024 threads a block": ("fwd", [("layernorm.cu", FWD_THREADS, FWD_THREADS.replace(
        "512", "1024"))]),
    "forward, 1024 threads a block, 2 blocks an SM": ("fwd", [
        ("layernorm.cu", FWD_THREADS, FWD_THREADS.replace("512", "1024")),
        ("layernorm.cu", FWD_BOUNDS, FWD_BOUNDS.replace("(kFwdMaxThreads)", "(kFwdMaxThreads, 2)"))]),
    "forward, 3 blocks an SM at two vectors a thread": ("fwd", [("layernorm.cu", FWD_BOUNDS,
        FWD_BOUNDS.replace("(kFwdMaxThreads)", "(kFwdMaxThreads, VPT == 2 ? 3 : 1)"))]),
    "backward, half the blocks": ("bwd", [("layernorm.cu", RESIDENT,
                                           "constexpr int kBwdResident = 512;")]),
    "backward, twice the blocks": ("bwd", [("layernorm.cu", RESIDENT,
                                            "constexpr int kBwdResident = 2048;")]),
}


def fwd_entry(lib_path):
    """The forward's C entry point of a built library."""
    fn = ctypes.CDLL(str(lib_path)).layernorm
    p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    fn.argtypes = [p, p, p, p, i, i, i64, i, f, p]
    fn.restype = i
    return fn


def variant_fwd(torch, fn, x, w, b):
    """One forward through a variant's C entry point."""
    from repro_torch.kernels.rmsnorm import _RMS_CODES

    y = torch.empty_like(x)
    codes = (_RMS_CODES[x.dtype] | _RMS_CODES[w.dtype] << 2
             | (3 if b is None else _RMS_CODES[b.dtype]) << 4)
    err = fn(x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(),
             x.shape[0], x.shape[1], x.shape[1], codes, 1e-5,
             torch._C._cuda_getCurrentRawStream(x.get_device()))
    if err:
        raise RuntimeError(f"variant launch failed: cudaError {err}")
    return y


def bwd_entry(lib_path):
    """(backward C entry point, grid function) of a built library."""
    lib = ctypes.CDLL(str(lib_path))
    p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    fn = lib.layernorm_bwd
    fn.argtypes = [p, p, p, p, p, p, p, i64, i, i, i64, i64, i, f, p]
    fn.restype = i
    return fn, lib.layernorm_bwd_grid


def variant_bwd(torch, entry, x, w, b, dy):
    """One backward through a variant's C entry point -> (dx, dw, db)."""
    from repro_torch.kernels.rmsnorm import _RMS_CODES

    fn, grid = entry
    rows, d = x.shape
    G = grid(rows, d, ctypes.byref(ctypes.c_int()))
    ws = torch.empty((2 * G * d,), dtype=torch.float32, device=x.device)
    dx, dw, db = torch.empty_like(x), torch.empty_like(w), torch.empty_like(b)
    codes = _RMS_CODES[x.dtype] | _RMS_CODES[w.dtype] << 2 | _RMS_CODES[b.dtype] << 4
    err = fn(x.data_ptr(), dy.data_ptr(), w.data_ptr(), dx.data_ptr(), dw.data_ptr(),
             db.data_ptr(), ws.data_ptr(), ws.numel(), rows, d, d, d, codes, 1e-5,
             torch._C._cuda_getCurrentRawStream(x.get_device()))
    if err:
        raise RuntimeError(f"variant launch failed: cudaError {err}")
    return dx, dw, db


def in_turns(torch, calls, rounds: int = 2):
    """{name: {"ms": mean back to back, "device_ms": mean device time of
    every kernel a call launches}}, each call timed in the order of
    ``calls`` and then back, ``rounds`` times."""
    runs = {n: [] for n in calls}
    for n in (list(calls) + list(calls)[::-1]) * rounds:
        runs[n].append((cs.time_ms(torch, calls[n]), cs.busy_ms(torch, calls[n])))
    out = {}
    for n, r in runs.items():
        devs = [t[1] for t in r if t[1]]
        out[n] = {"ms": sum(t[0] for t in r) / len(r),
                  "device_ms": sum(devs) / len(devs) if devs else None}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--save-parent", metavar="REV", default="")
    ap.add_argument("--parent", nargs="?", const=str(PARENT_DIR), default="", metavar="DIR")
    args = ap.parse_args()
    if args.save_parent:
        dv.save_parent(args.save_parent, Path(args.parent or PARENT_DIR), PARENT_FILES)
        return 0

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("layernorm_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import rmsnorm as tree

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    jobs = dv.build("layernorm", {label: edits for label, (_, edits) in VARIANTS.items()})
    _build.load("layernorm")
    built = dv.finish(jobs)
    fwd_variants = {label: fwd_entry(so) for label, so in built.items()
                    if VARIANTS[label][0] == "fwd"}
    variants = {label: bwd_entry(so) for label, so in built.items() if VARIANTS[label][0] == "bwd"}
    parent = None
    if args.parent:
        spec = importlib.util.spec_from_file_location("parent_rmsnorm",
                                                      Path(args.parent) / "rmsnorm.py")
        parent = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(parent)
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale + shift).to(dtype)

    readings = {"card": card, "forward": {}, "backward": {}}
    for rows, d, bias in cs.LAYERNORM_TIMED:
        x = randn(rows, d, scale=3.0, shift=1.0)
        w = randn(d, dtype=torch.float32)
        b = randn(d, dtype=torch.float32) if bias else None
        wl, bl = w.to(torch.bfloat16), None if b is None else b.to(torch.bfloat16)
        calls = {"tree": lambda: tree.layernorm(x, w, b),
                 "F.layer_norm": lambda: F.layer_norm(x, (d,), wl, bl, 1e-5)}
        if parent:
            calls["parent"] = lambda: parent.layernorm(x, w, b)
        for label, fn in fwd_variants.items():
            calls[label] = lambda fn=fn: variant_fwd(torch, fn, x, w, b)
        r = ref.layernorm_ref(x, w, b).float()
        tol, label = cs.layernorm_tol(torch, torch.bfloat16)
        outs = {n: calls[n]() for n in calls if n != "F.layer_norm"}
        within = {n: bool(((y.float() - r).abs() <= tol(r)).all()) for n, y in outs.items()}
        bits = {n: torch.equal(outs["tree"], y) for n, y in outs.items() if n != "tree"}
        nbytes = 2 * rows * d * 2 + (2 if bias else 1) * d * 4
        bound_ms, _ = cs.bound(8 * rows * d, nbytes, cs.PEAK_FP32_FLOPS)
        times = in_turns(torch, calls)
        key = f"({rows}, {d}){'' if bias else ' no bias'}"
        readings["forward"][key] = {"bound_ms": bound_ms, "within_tol": within,
                                    "tree_bits_equal": bits, **times}
        print(f"layernorm {key} bf16 on {card}: bound {bound_ms:.5f} ms; " + "; ".join(
            f"{n} {t['ms']:.4f} ms (device {cs.fmt_ms(t['device_ms'])})" for n, t in times.items())
            + f"; within {label} of the plain version {within}; equal to the tree's bit for bit "
            f"{bits}")
        del x, outs

    for rows, d, bias, wname in cs.LAYERNORM_BWD_TIMED:
        wdt = getattr(torch, wname)
        x, dy = randn(rows, d, scale=3.0, shift=1.0), randn(rows, d)
        w, b = randn(d, dtype=wdt), randn(d, dtype=wdt)
        want = ref.layernorm_bwd_ref(x, w, b, dy)
        got = tree.layernorm_bwd(x, w, b, dy)
        checks = {}
        calls = {"tree": lambda: tree.layernorm_bwd(x, w, b, dy)}
        for label, entry in variants.items():
            v = variant_bwd(torch, entry, x, w, b, dy)
            ok, errs = cs.layernorm_bwd_grads_ok(torch, v, want, torch.bfloat16)
            checks[label] = {"dx_bits_equal_tree": torch.equal(v[0], got[0]), "within_tol": ok,
                             "err_over_tol": errs}
            calls[label] = lambda entry=entry: variant_bwd(torch, entry, x, w, b, dy)
        times = in_turns(torch, calls)
        xl = x.detach().requires_grad_(True)
        wl, bl = (t.to(torch.bfloat16).requires_grad_(True) for t in (w, b))
        yl = F.layer_norm(xl, (d,), wl, bl, 1e-5)
        times.update(in_turns(torch, {
            "plain": lambda: ref.layernorm_bwd_ref(x, w, b, dy),
            "F.layer_norm backward": lambda: torch.autograd.grad(yl, (xl, wl, bl), dy,
                                                                 retain_graph=True)}, rounds=1))
        rows_bytes = 3 * rows * d * 2 + 4 * d * w.element_size()
        key = f"({rows}, {d}) {wname} w"
        readings["backward"][key] = {"bound_ms": cs.bound(0, rows_bytes)[0],
                                     "variants": checks, **times}
        print(f"layernorm_bwd {key} on {card}: bound "
              f"{cs.bound(0, rows_bytes)[0]:.5f} ms; " + "; ".join(
                  f"{n} {t['ms']:.4f} ms (device {cs.fmt_ms(t['device_ms'])})"
                  for n, t in times.items()))
        for label, c in checks.items():
            print(f"  {label}: dx = tree's bit for bit {c['dx_bits_equal_tree']}, within the "
                  f"check's tolerance {c['within_tol']} ({c['err_over_tol']})")
        del x, dy, xl, yl, want, got

    x = randn(32, 1024)
    w, b = randn(1024, dtype=torch.float32), randn(1024, dtype=torch.float32)
    wl, bl = w.to(torch.bfloat16), b.to(torch.bfloat16)
    parts = {"layernorm (the tree's wrapper)": lambda: tree.layernorm(x, w, b),
             "ops.layernorm, no gradient (the tree's)": lambda: ops.layernorm(x, w, b),
             "layernorm_bwd (the tree's wrapper)": lambda: tree.layernorm_bwd(x, wl, bl, x),
             "F.layer_norm": lambda: F.layer_norm(x, (1024,), wl, bl, 1e-5)}
    if parent:
        parts["layernorm (the parent's wrapper)"] = lambda: parent.layernorm(x, w, b)
        parts["ops.layernorm through the parent's autograd Function"] = (
            lambda: parent.layernorm_ad(x, w, b))
    host = {name: dv.per_call_us(torch, f, n=500) for name, f in parts.items()}
    readings["host µs a call at (32, 1024)"] = host
    print(f"---- host µs a call on {card}: " + ", ".join(f"{k} {v:.2f}" for k, v in host.items()))

    out = cs.ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "layernorm_variants.json").write_text(json.dumps(readings, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
