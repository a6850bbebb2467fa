#!/usr/bin/env python3
"""Time the grouped matmul's kernels against the parent's and against
variants of their design, at Llama-4-Scout's shapes.

    python3 gmm_variants.py [--parent PATH]

Needs one card.  Each variant is a textual edit of
``csrc/grouped_matmul.cu`` built into its own library under
``kernels/build/variants/`` (the source in the tree is not changed), all
with one nvcc each, started together.  The forward's variants (timed at
Scout's decode w_in and w_out, prefill and training shapes):

- "decode through row tiles": the decode mode's shapes taken by the
  row-tile mode, m64 blocks with the group's rows padded to 64 and no
  split over K;
- "split 1", "split 2", "split 4", "split 8": the decode mode's K split
  fixed, where the tree picks it from the live groups;
- "decode at n 32 only": every decode-mode product 32 rows wide, where
  the tree takes 8 or 16 for a group of as many rows.

The backward's variants (timed at Scout's w_in and w_out training shapes):

- "dW tiles N-fastest": gmm_dw's tiles taken N tile before K tile;
- "dW stores without the evict-first hint": an evict-normal L2 policy;
- "row tiles of 128": the transposed mode's (and the forward's row-tile
  mode's) tiles of two m64 blocks.

``--parent PATH`` adds a library built from an older source, e.g.
``git show <commit>:src/repro_torch/kernels/csrc/grouped_matmul.cu``,
with that commit's headers beside it (a header beside the source is found
before the tree's); a source whose entry takes ``block_m`` (before the
forward's decode mode) is called that way.  For every library, in the
order parent, tree, variants and then back, it times each call: CUDA
events over back-to-back calls and the profiler's device time
(``chip_smoke.device_ms``).  Beside them: ``torch._grouped_mm`` for the
same function, the bound, and whether each library's outputs equal the
tree's bit for bit.  Writes the readings to
``chiprun_out/gmm_variants.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

SRC = "grouped_matmul"
# name -> (the calls it is timed on, its edits of the source)
VARIANTS = {
    "decode through row tiles": ("forward", [("  if (M > split::kMaxRows) {", "  if (M > 0) {")]),
    "split 1": ("forward", [("  return best;\n}", "  return min(best, 1);\n}")]),
    "split 2": ("forward", [("  return best;\n}", "  return min(2 + 0 * best, n_slices);\n}")]),
    "split 4": ("forward", [("  return best;\n}", "  return min(4 + 0 * best, n_slices);\n}")]),
    "split 8": ("forward", [("  return best;\n}", "  return min(8 + 0 * best, n_slices);\n}")]),
    "decode at n 32 only": ("forward", [("    if (rows <= 8)", "    if (rows <= 0)"),
                                        ("    else if (rows <= 16)", "    else if (rows <= 0)")]),
    "dW tiles N-fastest": ("backward", [(
        "    k0 = (t % p.tiles_k) * dw::kBK;\n    n0 = (t / p.tiles_k % p.tiles_n) * dw::kBN;",
        "    n0 = (t % p.tiles_n) * dw::kBN;\n    k0 = (t / p.tiles_n % p.tiles_k) * dw::kBK;")]),
    "dW stores without the evict-first hint": ("backward", [(
        "const uint64_t store_policy = l2_evict_first();",
        "uint64_t store_policy;\n  asm volatile(\"createpolicy.fractional.L2::evict_normal.b64 "
        "%0, 1.0;\" : \"=l\"(store_policy));")]),
    "row tiles of 128": ("backward", [("constexpr int kBM = 256;", "constexpr int kBM = 128;")]),
}


def build(parent):
    """One nvcc per variant (and the parent), all started together ->
    {name: library path}."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / f"{SRC}.cu").read_text()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {}
    for i, (name, (_, edits)) in enumerate(VARIANTS.items()):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: {old!r} is not in the source once")
            text = text.replace(old, new)
        cu = out_dir / f"{SRC}_variant{i}.cu"
        cu.write_text(text)
        sources[name] = cu
    if parent:
        sources["parent"] = Path(parent).resolve()
    jobs = {}
    for i, (name, cu) in enumerate(sources.items()):
        so = out_dir / f"{SRC}_variant{i}.so"
        cmd = [_build.nvcc(), *_build.FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True))
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


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("gmm_variants: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default="")
    args = ap.parse_args()

    from repro_torch.kernels import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.finish_builds(_build.start_builds([SRC]))
    libs = {"tree": _build.lib_path(SRC), **build(args.parent)}
    old_entry = bool(args.parent) and "int block_m" in Path(args.parent).read_text()
    P, I = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for name, so in libs.items():
        lib = ctypes.CDLL(str(so))
        lib.grouped_matmul.argtypes = ([P] * 4 + [I] * 6 + [P] if name == "parent" and old_entry
                                       else [P] * 5 + [I] * 5 + [P])
        lib.grouped_matmul_dw.argtypes = [P] * 4 + [I] * 5 + [P]
        fns[name] = lib

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def dw(name, x, dy, gs, out_dtype):
        E, (M, K), N = gs.shape[0], x.shape, dy.shape[1]
        out = torch.empty(E, K, N, dtype=out_dtype, device="cuda")
        err = fns[name].grouped_matmul_dw(x.data_ptr(), dy.data_ptr(), gs.data_ptr(), out.data_ptr(),
                                         M, K, N, E, int(out_dtype == torch.bfloat16), stream())
        if err:
            raise RuntimeError(f"{name}: gmm_dw launch failed ({err})")
        return out

    def gmm(name, x, w, gs, trans):
        M, (E, K, N) = x.shape[0], w.shape
        if trans:
            K, N = N, K
        out = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")
        if name == "parent" and old_entry:
            err = fns[name].grouped_matmul(x.data_ptr(), w.data_ptr(), gs.data_ptr(), out.data_ptr(),
                                           M, K, N, E, 16 if M <= 128 else 64, int(trans), stream())
        else:
            ws = torch.empty(8, M, N, dtype=torch.float32, device="cuda") if M <= 128 else None
            err = fns[name].grouped_matmul(x.data_ptr(), w.data_ptr(), gs.data_ptr(), out.data_ptr(),
                                           None if ws is None else ws.data_ptr(), M, K, N, E,
                                           int(trans), stream())
        if err:
            raise RuntimeError(f"{name}: gmm launch failed ({err})")
        return out

    dev = torch.device("cuda")
    torch.manual_seed(0)
    readings = {name: {} for name in fns}

    def compare(label, calls, kind):
        """Bits against the tree's, then each library timed in turns (the
        order and back) on every call of ``calls``: {what: (call, library
        call or None, (bound ms, by), flops)}."""
        order = (["parent"] * bool(args.parent) + ["tree"]
                 + [n for n, (k, _) in VARIANTS.items() if k == kind and n in fns])
        for what, (call, lib, (bound_ms, bound_by), flops) in calls.items():
            want = call("tree")
            torch.cuda.synchronize()
            for name in order:
                readings[name][f"{label} {what}: bit-identical to the tree"] = torch.equal(call(name),
                                                                                          want)
            times = {name: [] for name in order}
            for name in order + order[::-1]:
                times[name].append((cs.time_ms(torch, lambda: call(name), trials=10),
                                    cs.device_ms(torch, lambda: call(name), "gmm", n=10,
                                                 floor=bound_ms)))
            lib_ms = cs.time_ms(torch, lib, trials=10) if lib and hasattr(torch, "_grouped_mm") else None
            print(f"---- {label} {what} on {card}: bound {bound_ms:.4f} ms by {bound_by}; "
                  f"torch._grouped_mm {cs.fmt_ms(lib_ms)} ms")
            for name in order:
                ms = sum(t[0] for t in times[name]) / 2
                devs = [t[1] for t in times[name] if t[1]]
                dev_ms = sum(devs) / len(devs) if devs else None
                same = readings[name][f"{label} {what}: bit-identical to the tree"]
                readings[name][f"{label} {what}"] = {
                    "ms": ms, "device_ms": dev_ms, "runs": times[name], "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": lib_ms,
                    "tflops": flops / dev_ms / 1e9 if dev_ms else None}
                print(f"{name}: {ms:.4f} ms back to back, device {cs.fmt_ms(dev_ms)} ms "
                      f"({cs.per_device_ms(flops, dev_ms, 'TFLOP/s', 1e9)}), runs {times[name]}, "
                      f"bit-identical to the tree: {same}")

    # the forward at check_gmm's Scout shapes and sizes (its draws, in order)
    rng = np.random.default_rng(2)
    draws = {"decode w_in": (32, cs._router_sizes(np, rng, 32, 16, empty=(3,))),
             "prefill w_in, capacity 80": (1024, cs._router_sizes(np, rng, 1024, 16, cap=80)),
             "decode w_out": (32, cs._router_sizes(np, rng, 32, 16, empty=(0, 9))),
             "training w_in, capacity 160": (2048, cs.gmm_train_sizes(np)["w_in"])}
    weights = {"w_in": (torch.randn(16, 5120, 8192, device=dev) * 5120 ** -0.5).bfloat16(),
               "w_out": (torch.randn(16, 8192, 5120, device=dev) * 8192 ** -0.5).bfloat16()}
    for label, (M, s) in draws.items():
        w = weights["w_out" if "w_out" in label else "w_in"]
        E, K, N = w.shape
        total, live = int(s.sum()), int((s > 0).sum())
        x = torch.randn(M, K, device=dev).bfloat16()
        gs = torch.as_tensor(s, dtype=torch.int32, device=dev)
        ends = torch.cumsum(gs, 0, dtype=torch.int32)
        calls = {"forward": (lambda n: gmm(n, x, w, gs, False),
                             lambda: torch._grouped_mm(x, w, offs=ends),
                             cs.bound(2 * total * K * N, live * K * N * 2 + M * (K + N) * 2 + E * 4),
                             2 * total * K * N)}
        compare(f"scout {label} (M {M}, {live} of {E} live)", calls, "forward")
        del x
    del weights

    # the backward at Scout's training shapes (check_gmm_dw's sizes)
    sizes = cs.gmm_train_sizes(np)
    for label, (K, N) in {"w_in": (5120, 8192), "w_out": (8192, 5120)}.items():
        s = sizes[label]
        E, M, total, live = len(s), 2048, int(s.sum()), int((s > 0).sum())
        x = torch.randn(M, K, device=dev).bfloat16()
        dy = torch.randn(M, N, device=dev).bfloat16()
        x[total:], dy[total:] = 1e30, -1e30
        w = (torch.randn(E, K, N, device=dev) * K ** -0.5).bfloat16()
        gs = torch.as_tensor(s, dtype=torch.int32, device=dev)
        ends = torch.cumsum(gs, 0, dtype=torch.int32)
        wt = w.transpose(1, 2)
        flops = 2 * total * K * N
        calls = {
            "dW bf16": (lambda n: dw(n, x, dy, gs, torch.bfloat16),
                        lambda: torch._grouped_mm(x.t(), dy, offs=ends),
                        cs.bound(flops, total * (K + N) * 2 + E * K * N * 2 + E * 4), flops),
            "dW fp32": (lambda n: dw(n, x, dy, gs, torch.float32), None,
                        cs.bound(flops, total * (K + N) * 2 + E * K * N * 4 + E * 4), flops),
            "dx": (lambda n: gmm(n, dy, w, gs, True),
                   lambda: torch._grouped_mm(dy, wt, offs=ends),
                   cs.bound(flops, live * K * N * 2 + M * N * 2 + M * K * 2 + E * 4), flops),
        }
        compare(f"scout training {label} (M {M}, {live} of {E} live, {total} rows)", calls,
                "backward")
        del x, dy, w, wt

    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "gmm_variants.json").write_text(json.dumps({"card": card, "readings": readings},
                                                      indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
