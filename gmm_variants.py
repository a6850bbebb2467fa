#!/usr/bin/env python3
"""Time the grouped matmul's backward kernels against the parent's and
against variants of their design, at Llama-4-Scout's training shapes.

    python3 gmm_variants.py [--parent PATH]

Needs one card.  Each variant is a textual edit of
``csrc/grouped_matmul.cu`` built into its own library under
``kernels/build/variants/`` (the source in the tree is not changed), all
with one nvcc each, started together:

- "dW tiles N-fastest": gmm_dw's tiles taken N tile before K tile;
- "dW ring of 2 stages": gmm_dw's ring one stage shorter;
- "dW stores without the evict-first hint": an evict-normal L2 policy;
- "dx weight loads evict-first": the transposed mode's weight tiles (read
  once a call) loaded with an L2 evict-first hint;
- "dx row tiles of 128": the transposed mode's tiles of two m64 blocks (a
  160-row group then takes two tiles and reads its weights twice);
- "dx 3 stages": the transposed mode's ring one stage shorter.

``--parent PATH`` adds a library built from an older source with the same C
interface, e.g. ``git show <commit>:src/repro_torch/kernels/csrc/
grouped_matmul.cu``, with that commit's ``mma.cuh`` beside it (a header
beside the source is found before the tree's).  For every
library, in the order parent, tree, variants and then back, it times gmm_dw
(bf16 and fp32 dW) and the transposed gmm (dx) at Scout's w_in (K 5120, N
8192) and w_out (K 8192, N 5120) training shapes, with the sizes
``chip_smoke.check_gmm_dw`` draws: CUDA events over back-to-back calls and
the profiler's device time.  Beside them: ``torch._grouped_mm`` for the
same function, the bound, and whether each library's outputs equal the
tree's bit for bit (and, for the parent, the forward's at Scout's decode and
prefill shapes).  Writes the readings to ``chiprun_out/gmm_variants.json``.
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
VARIANTS = {
    "dW tiles N-fastest": [(
        "    k0 = (t % p.tiles_k) * dw::kBK;\n    n0 = (t / p.tiles_k % p.tiles_n) * dw::kBN;",
        "    n0 = (t % p.tiles_n) * dw::kBN;\n    k0 = (t / p.tiles_n % p.tiles_k) * dw::kBK;")],
    "dW ring of 2 stages": [("constexpr int kStages = 3;\nconstexpr int kOut",
                             "constexpr int kStages = 2;\nconstexpr int kOut")],
    "dW stores without the evict-first hint": [(
        "const uint64_t store_policy = l2_evict_first();",
        "uint64_t store_policy;\n  asm volatile(\"createpolicy.fractional.L2::evict_normal.b64 "
        "%0, 1.0;\" : \"=l\"(store_policy));")],
    "dx weight loads evict-first": [(
        "tma_load(st + kABytes, &mw, 64 * s, it.n0, it.q, &full[stage]);",
        "asm volatile(\"{\\n.reg .b64 pol;\\ncreatepolicy.fractional.L2::evict_first.b64 pol, "
        "1.0;\\ncp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".L2::cache_hint [%0], [%1, {%3, %4, %5}], [%2], pol;\\n}\\n\" :: \"r\"(st + kABytes), "
        "\"l\"(reinterpret_cast<uint64_t>(&mw)), \"r\"(smem_u32(&full[stage])), \"r\"(64 * s), "
        "\"r\"(it.n0), \"r\"(it.q) : \"memory\");")],
    "dx row tiles of 128": [("constexpr int kBM = 256;", "constexpr int kBM = 128;")],
    "dx 3 stages": [("constexpr int kStages = 4;", "constexpr int kStages = 3;")],
}


def build(parent):
    """One nvcc per variant (and the parent), all started together ->
    {name: library path}."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / f"{SRC}.cu").read_text()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: {old!r} is not in the source")
            text = text.replace(old, new, 1)
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

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build, ref

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.finish_builds(_build.start_builds([SRC]))
    libs = {"tree": _build.lib_path(SRC), **build(args.parent)}
    order = ["parent"] * bool(args.parent) + ["tree"] + [n for n in VARIANTS if n in libs]
    P, I = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for name, so in libs.items():
        lib = ctypes.CDLL(str(so))
        lib.grouped_matmul.argtypes = [P] * 4 + [I] * 6 + [P]
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
        err = fns[name].grouped_matmul(x.data_ptr(), w.data_ptr(), gs.data_ptr(), out.data_ptr(),
                                       M, K, N, E, 16 if M <= 128 else 64, int(trans), stream())
        if err:
            raise RuntimeError(f"{name}: gmm launch failed ({err})")
        return out

    def device_ms(fn, n=10):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        # per launch over the launches the profiler recorded (one a call)
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and "gmm" in e.key.lower()]
        count = sum(e.count for e in ev)
        return sum(e.self_device_time_total for e in ev) / 1e3 / count if count else None

    dev = torch.device("cuda")
    torch.manual_seed(0)
    sizes = cs.gmm_train_sizes(np)
    readings = {name: {} for name in fns}
    shapes = {"w_in": (5120, 8192), "w_out": (8192, 5120)}
    for label, (K, N) in shapes.items():
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
                        cs.bound(flops, total * (K + N) * 2 + E * K * N * 2 + E * 4)),
            "dW fp32": (lambda n: dw(n, x, dy, gs, torch.float32), None,
                        cs.bound(flops, total * (K + N) * 2 + E * K * N * 4 + E * 4)),
            "dx": (lambda n: gmm(n, dy, w, gs, True),
                   lambda: torch._grouped_mm(dy, wt, offs=ends),
                   cs.bound(flops, live * K * N * 2 + M * N * 2 + M * K * 2 + E * 4)),
        }
        for what, (call, lib, (bound_ms, bound_by)) in calls.items():
            want = call("tree")
            torch.cuda.synchronize()
            for name in order:
                same = torch.equal(call(name), want)
                readings[name][f"{label} {what}: bit-identical to the tree"] = same
            times = {name: [] for name in order}
            for name in order + order[::-1]:
                times[name].append((cs.time_ms(torch, lambda: call(name), trials=10),
                                    device_ms(lambda: call(name))))
            lib_ms = cs.time_ms(torch, lib, trials=10) if lib and hasattr(torch, "_grouped_mm") else None
            print(f"---- {label} {what} (M {M}, K {K}, N {N}, {live} of {E} groups live, {total} rows) "
                  f"on {card}: bound {bound_ms:.4f} ms by {bound_by}; torch._grouped_mm "
                  f"{cs.fmt_ms(lib_ms)} ms")
            for name in order:
                ms = sum(t[0] for t in times[name]) / 2
                devs = [t[1] for t in times[name] if t[1]]
                dev_ms = sum(devs) / len(devs) if devs else None
                readings[name][f"{label} {what}"] = {
                    "ms": ms, "device_ms": dev_ms, "runs": times[name], "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": lib_ms,
                    "tflops": flops / dev_ms / 1e9 if dev_ms else None}
                print(f"{name}: {ms:.4f} ms back to back, device {cs.fmt_ms(dev_ms)} ms "
                      f"({cs.per_device_ms(flops, dev_ms, 'TFLOP/s', 1e9)}), runs {times[name]}, "
                      f"bit-identical to the tree: "
                      f"{readings[name][f'{label} {what}: bit-identical to the tree']}")
        del x, dy, w, wt

    if args.parent:   # the forward (gmm_kernel) keeps its bits: the parent's outputs against the tree's
        rng = np.random.default_rng(2)
        w_in = (torch.randn(16, 5120, 8192, device=dev) * 5120 ** -0.5).bfloat16()
        for label, M, s in (("decode", 32, cs._router_sizes(np, rng, 32, 16, empty=(3,))),
                            ("prefill", 1024, cs._router_sizes(np, rng, 1024, 16, cap=80))):
            x = torch.randn(M, 5120, device=dev).bfloat16()
            gs = torch.as_tensor(s, dtype=torch.int32, device=dev)
            same = torch.equal(gmm("parent", x, w_in, gs, False), gmm("tree", x, w_in, gs, False))
            readings["parent"][f"forward, scout {label}: bit-identical to the tree"] = same
            print(f"forward (gmm_kernel), scout {label} w_in (M {M}): parent's output bit-identical "
                  f"to the tree's: {same}")

    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "gmm_variants.json").write_text(json.dumps({"card": card, "readings": readings},
                                                      indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
