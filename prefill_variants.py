#!/usr/bin/env python3
"""Time the prefill kernels -- the SSD chunked scan and the paged chunk
prefill -- and the SSD scan's backward against the parent's and against
variants of their designs, and hold the dense attention forward (whose
consumer body the paged prefill shares) to the parent's bits.

    python3 prefill_variants.py --save-parent REV   # in a git checkout
    python3 prefill_variants.py [--parent [DIR]] [--kernels K1,K2]   # on one card

``--kernels`` picks among ssd_scan, paged_prefill, flash_attention_fwd and
ssd_scan_bwd (by default all).  ``--save-parent REV`` writes ``git show
REV:`` of ``csrc/ssd_scan.cu``, ``csrc/ssd_scan_bwd.cu``,
``csrc/paged_attention.cu``, ``csrc/flash_attention_fwd.cu`` and the
headers they include (``mma.cuh``, ``hopper.cuh``, ``decode_split.cuh``,
and ``attention_fwd.cuh`` where REV has it) into DIR (by default
``.chip_archive/parent_prefill/``: ignored by git, skipped by pytest,
carried by a copy of the tree) and stops.  On the card, ``--parent`` adds
those sources as the library "parent" of each kernel, built with its own
headers beside it (found before the tree's).

Needs one card.  Each variant is a textual edit of a source, written into
a directory of its own under ``kernels/build/variants/`` (the tree is not
changed) and built with the tree's headers behind it, one nvcc each, all
started together:

- ssd_scan: "4 warps" and "16 warps" (one or four warps a 16-row block of
  the chunk; the tree: 8, two a block, each half of y's columns), "P slices of 32" (160 blocks of
  32 state rows at Mamba2's shape; the tree: 80 of 64), "state high half
  only in C h^T" (the carried state's low half dropped from y's product:
  what the split costs there; its y error is printed);
- paged_prefill: "rows gathered by cp.async at page 16" (the path of pages
  that are not a multiple of 8; the tree: TMA boxes of 16 rows), "boxes of
  8 rows" (the swizzle atom);
- ssd_scan_bwd: the state pass's "ring of 3" and "of 4" (chunks in flight
  ahead of its walk; the tree: 2), "rows of 64" (160 blocks of 64 x 64 at
  Mamba2's shape; the tree: 320 of 32 x 64), both, and "columns of 32"
  (640 blocks of 32 x 32); "dh_out high half only in dx" (the low half of one split
  operand dropped: its gate margins are printed); some that only time a
  part, their outputs wrong where a phase is skipped -- "no epilogue" (a
  head's ddt, dA and dD), "no Z", "no V", "no dx", "no dS, R", "no dB, dC
  products", "no copies after the first", "no head prefetch" (a head's
  copies waited for before it computes), the state pass's "no dh store"
  and "no products"; and the tree's library called with other runs of K
  heads (the wrapper's choice at Mamba2's shape on 132 SMs: 10).

Each library runs in turns (the order and then back, so two profiler
windows each) at each shape: CUDA events over back-to-back calls and the
profiler's device time (``chip_smoke.device_ms``), beside the bound and
the output against the plain version and against the tree's bits.
ssd_scan at Mamba2-2.7B's admission lengths S = 64, 256, 544 and 1024
(B 1, H 80, P 64, N 128); paged_prefill at Qwen2-7B's 512-token chunk at
start 512 and at the 64-token bucket at start 1000 (pages of 16, chip_smoke's
pool); flash_attention_fwd, parent and tree, at Qwen2's prefill and ESM-2's
serving shapes; ssd_scan_bwd at Mamba2-2.7B's training shape (B 1, S
1024, H 80, P 64, N 128), each library's device time split by kernel and
its gate margins (dx, dB, dC in bf16 steps of each row's max|plain|, ddt,
dA, dD relative to their max|plain|, as ``check_ssd_scan_bwd``), and the
margins again at large steps (dt·|A| up to ~50 a row).  Writes the
readings to ``chiprun_out/prefill_variants.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs
import decode_variants as dv

CSRC = "src/repro_torch/kernels/csrc"
PARENT_FILES = {name: f"{CSRC}/{name}" for name in (
    "ssd_scan.cu", "ssd_scan_bwd.cu", "paged_attention.cu", "flash_attention_fwd.cu", "mma.cuh", "hopper.cuh",
    "decode_split.cuh")}
PARENT_DIR = cs.ROOT / ".chip_archive" / "parent_prefill"
SSD_VARIANTS = {
    "4 warps": [("ssd_scan.cu", "constexpr int kWarps = 8;", "constexpr int kWarps = 4;")],
    "16 warps": [("ssd_scan.cu", "constexpr int kWarps = 8;", "constexpr int kWarps = 16;")],
    "P slices of 32": [("ssd_scan.cu", "const int pt = P % 64 == 0 ? 64 : 32;",
                        "const int pt = 32;")],
    "state high half only in C h^T": [
        ("ssd_scan.cu", "ldsm4(bl, b_rows(hLo, kNP, y0 + 16 * jp, 16 * kk, lane));", ""),
        ("ssd_scan.cu", """            Mma<T>::run(y[2 * jp], ca, bl[0], bl[1]);
            Mma<T>::run(y[2 * jp + 1], ca, bl[2], bl[3]);
""", "")],
}
BWD = "ssd_scan_bwd.cu"
BWD_VARIANTS = {
    "state ring of 3": [(BWD, "constexpr int kStateStages = 2;", "constexpr int kStateStages = 3;")],
    "state ring of 4": [(BWD, "constexpr int kStateStages = 2;", "constexpr int kStateStages = 4;")],
    "state rows of 64": [(BWD, "constexpr int kStateRows = 32;", "constexpr int kStateRows = 64;")],
    "state rows of 64, ring of 3": [
        (BWD, "constexpr int kStateRows = 32;", "constexpr int kStateRows = 64;"),
        (BWD, "constexpr int kStateStages = 2;", "constexpr int kStateStages = 3;")],
    "state columns of 32": [(BWD, "static constexpr int kSN = NP >= 64 ? 64 : 32;",
                             "static constexpr int kSN = 32;")],
    "dh_out high half only in dx": [(BWD, """        ldsm4(bl, swz_rows<NP>(sDHl, pw0 + 16 * jp, 16 * kk, lane));
        Mma<T>::run(acc[2 * jp], ba, bh[0], bh[1]);
        Mma<T>::run(acc[2 * jp + 1], ba, bh[2], bh[3]);
        Mma<T>::run(acc[2 * jp], ba, bl[0], bl[1]);
        Mma<T>::run(acc[2 * jp + 1], ba, bl[2], bl[3]);
""", """        Mma<T>::run(acc[2 * jp], ba, bh[0], bh[1]);
        Mma<T>::run(acc[2 * jp + 1], ba, bh[2], bh[3]);
""")],
    "no epilogue (timing only)": [(BWD, "if (warp == kEpiWarp) {",
                                   "if (warp == kEpiWarp && p.B < 0) {")],
    "no Z (timing only)": [(BWD, """    if (n_active) {
      // Z = dy h_in""", """    if (n_active && p.B < 0) {
      // Z = dy h_in""")],
    "no V (timing only)": [(BWD, """    if (n_active) {
      // V = x dh_out""", """    if (n_active && p.B < 0) {
      // V = x dh_out""")],
    "no dx (timing only)": [(BWD, "    if (ns == 1) do_dx(h, 0, s);\n", "")],
    "no dS, R (timing only)": [(BWD, """        if (j / 2 < rb) continue;
        float q0 = 0.f, q1 = 0.f;""", """        if (j / 2 < rb || p.B > 0) continue;
        float q0 = 0.f, q1 = 0.f;""")],
    "no dB, dC products (timing only)": [
        (BWD, "if (n_active) {  // dB += dS^T C", "if (n_active && p.B < 0) {  // dB"),
        (BWD, "if (n_active) {  // dC += dS B", "if (n_active && p.B < 0) {  // dC")],
    "no copies after the first (timing only)": [(BWD, """    mbar_wait(&bars[st], (i >> 1) & 1);
    __syncthreads();  // step i has landed; step i - 1 is done with the other stage
    load_step(i + 1, st ^ 1);""", """    if (i == 0) mbar_wait(&bars[st], 0);
    __syncthreads();  // step i has landed; step i - 1 is done with the other stage""")],
    "no head prefetch (timing only)": [(BWD, """    cp_async_wait<0>();
    mbar_wait(&bars[st], (i >> 1) & 1);
    __syncthreads();  // step i has landed; step i - 1 is done with the other stage
    load_step(i + 1, st ^ 1);""", """    load_step(i + 1, st ^ 1);
    cp_async_wait<0>();
    if (i + 1 < n_steps) mbar_wait(&bars[st ^ 1], ((i + 1) >> 1) & 1);
    mbar_wait(&bars[st], (i >> 1) & 1);
    __syncthreads();""")],
    "state: no dh store (timing only)": [(BWD, """        *reinterpret_cast<uint4*>(dst + drow * NP + 8 * swz<NP>(prow, (n0 >> 3) + piece)) =""", """        if (p.B < 0) *reinterpret_cast<uint4*>(dst + drow * NP + 8 * swz<NP>(prow, (n0 >> 3) + piece)) =""")],
    "state: no products (timing only)": [(BWD, """    for (int ks = 0; ks < kL / 16; ++ks) {
      const int t0 = 16 * ks + 2 * tq;""", """    for (int ks = 0; ks < kL / 16 && p.B < 0; ++ks) {
      const int t0 = 16 * ks + 2 * tq;""")],
}
BWD_KS = (1, 2, 4, 5, 20)   # runs of K heads beside the tree's choice
BWD_SPLIT = ("ssd_bwd_state", "ssd_bwd_chunk", "ssd_bwd_sum", "ssd_bwd_group", "ssd_bwd_head")
PAGED_VARIANTS = {
    "rows gathered by cp.async at page 16": [("paged_attention.cu",
                                              "const bool gather = p.box_rows == 0;",
                                              "const bool gather = true;")],
    "boxes of 8 rows": [("paged_attention.cu", "p.box_rows = page % 64 == 0 ? 64 :",
                         "p.box_rows = page % 8 == 0 ? 8 : page % 64 == 0 ? 64 :")],
}


def save_parent(rev: str, out: Path) -> None:
    files = dict(PARENT_FILES)
    has_header = subprocess.run(["git", "cat-file", "-e", f"{rev}:{CSRC}/attention_fwd.cuh"],
                                cwd=cs.ROOT, stderr=subprocess.DEVNULL).returncode == 0
    if has_header:
        files["attention_fwd.cuh"] = f"{CSRC}/attention_fwd.cuh"
    dv.save_parent(rev, out, files)


def bwd_section(torch, cs, libs, names, report, g, dev):
    """ssd_scan_bwd at Mamba2-2.7B's training shape: every library in turns
    (and the tree's with other runs of K heads), then each one's gate
    margins at large steps."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import _padded_n, _scan, heads_a_run

    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def case(B, S, H, Pd, N, shift):
        args = cs._ssd_case(torch, g, B, S, H, Pd, 1, N, shift)
        _, _, states = _scan(*args, 64, states=True)
        dy = torch.randn(B, S, H, Pd, generator=g, device=dev).to(torch.bfloat16)
        f32 = [a.float() for a in args]
        _, _, want_states = ref.ssd_scan_ref(*f32, chunk=64, states=True)
        want = ref.ssd_scan_bwd_ref(*f32, want_states, dy.float(), None, chunk=64)
        return args, states, dy, want

    def caller(args, states, dy):
        x, dt, A, Bm, Cm, D = args
        B, S, H, Pd = x.shape
        N, nc = Bm.shape[3], states.shape[1]

        def call(n):
            lib, K = libs["tree" if n.startswith("K=") else n], heads_a_run(B, nc, H, 1, sms)
            if n.startswith("K="):
                K = int(n[2:])
            f32 = dict(dtype=torch.float32, device=dev)
            old = n == "parent"   # the parent's scratch: fp32 dh and per-head dB, dC partials
            dh = (torch.empty_like(states) if old else
                  torch.empty((B, nc, H, 2, Pd, _padded_n(N)), dtype=torch.bfloat16, device=dev))
            dBp, dCp = torch.empty((2, B, S, H if old else H // K, N), **f32)
            dAp, dDp = torch.empty((2, B, nc, H), **f32)
            dx = torch.empty((B, S, H, Pd), dtype=x.dtype, device=dev)
            ddt = torch.empty((B, S, H), **f32)
            dB, dC = (torch.empty((B, S, 1, N), dtype=Bm.dtype, device=dev) for _ in range(2))
            dA, dD = torch.empty(H, **f32), torch.empty(H, **f32)
            err = lib.ssd_scan_bwd(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                D.data_ptr(), states.data_ptr(), dy.data_ptr(), None, dh.data_ptr(),
                dx.data_ptr(), ddt.data_ptr(), dBp.data_ptr(), dCp.data_ptr(), dAp.data_ptr(),
                dDp.data_ptr(), dB.data_ptr(), dC.data_ptr(), dA.data_ptr(), dD.data_ptr(),
                *x.stride()[:3], *Bm.stride()[:3], *dt.stride()[:2], B, S, H, Pd, 1, N,
                *(() if old else (K,)), stream)
            if err:
                raise RuntimeError(f"{n}: ssd_scan_bwd launch failed ({err})")
            return dx, ddt, dA, dB, dC, dD
        return call

    def margins(want):
        def compare(out):
            errs = {n: cs.bf16_steps(torch, out[i], want[i], 3)
                    for i, n in ((0, "dx_bf16_steps"), (3, "dB_bf16_steps"), (4, "dC_bf16_steps"))}
            errs.update({n: cs.rel_err(out[i], want[i])
                         for i, n in ((1, "ddt_err"), (2, "dA_err"), (5, "dD_err"))})
            return errs
        return compare

    B, S, H, Pd, N = 1, 1024, 80, 64, 128
    args, states, dy, want = case(B, S, H, Pd, N, -4.0)
    ks = [f"K={k}" for k in BWD_KS if k != heads_a_run(B, -(-S // 64), H, 1, sms)]
    report("ssd_scan_bwd", f"mamba2-2.7b training S={S}", list(names) + ks,
           caller(args, states, dy), margins(want), cs.ssd_bwd_bound(B, S, H, Pd, 1, N)[0],
           "ssd_bwd", split=BWD_SPLIT)
    args, states, dy, want = case(1, 256, 8, Pd, N, 1.5)
    call, compare = caller(args, states, dy), margins(want)
    print("---- ssd_scan_bwd gate margins at large steps (B 1, S 256, H 8, P 64, N 128)")
    for n in names:
        print(f"{n}: " + ", ".join(f"{k} {v:.3g}" for k, v in compare(call(n)).items()))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--save-parent", metavar="REV", default="")
    ap.add_argument("--parent", nargs="?", const=str(PARENT_DIR), default="", metavar="DIR")
    ap.add_argument("--kernels", default="ssd_scan,paged_prefill,flash_attention_fwd,ssd_scan_bwd")
    args = ap.parse_args()
    want = set(args.kernels.split(","))
    if args.save_parent:
        save_parent(args.save_parent, Path(args.parent or PARENT_DIR))
        return 0

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("prefill_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ref

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    parent = Path(args.parent).resolve() if args.parent else None
    sources = {"ssd_scan": ("ssd_scan", SSD_VARIANTS), "paged_prefill": ("paged_attention",
                                                                        PAGED_VARIANTS),
               "flash_attention_fwd": ("flash_attention_fwd", {}),
               "ssd_scan_bwd": ("ssd_scan_bwd", BWD_VARIANTS)}
    sources = {k: v for k, v in sources.items() if k in want}
    # the backward's reference needs the tree's forward for its chunk states
    jobs = _build.start_builds(sorted({v[0] for v in sources.values()} | (
        {"ssd_scan"} if "ssd_scan_bwd" in want else set())))
    var_jobs = {v[0]: dv.build(v[0], v[1], parent) for v in sources.values()}
    _build.finish_builds(jobs)
    P, I, I64, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    libs = {}
    for kern, pending in var_jobs.items():
        libs[kern] = {}
        for label, so in {"tree": _build.lib_path(kern), **dv.finish(pending)}.items():
            lib = ctypes.CDLL(str(so))
            if kern == "ssd_scan":
                lib.ssd_scan.argtypes = [P] * 8 + [I64] * 8 + [I] * 6 + [P]
            elif kern == "ssd_scan_bwd":   # the parent's entry took no K
                lib.ssd_scan_bwd.argtypes = [P] * 20 + [I64] * 8 + [I] * (
                    6 if label == "parent" else 7) + [P]
            elif kern == "paged_attention":   # the parent's entry took the pool's strides
                lib.paged_flash_prefill.argtypes = (
                    [P] * 7 + [I] * 7 + [I64] * 10 + [F32, P] if label == "parent"
                    else [P] * 7 + [I] * 8 + [I64] * 7 + [F32, P])
            else:
                lib.flash_attention_fwd.argtypes = ([P] * 5 + [I] * 7 + [P] + [I64] * 3
                                                    + [I, I, F32, I, P])
            libs[kern][label] = lib
    order = {k: ["parent"] * bool(parent) + ["tree"] + [n for n in v if n not in ("parent", "tree")]
             for k, v in libs.items()}
    stream = torch.cuda.current_stream().cuda_stream
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=g, device=dev) * scale + shift).to(dtype)

    readings = {"card": card}

    def report(kernel, label, names, call, compare, bound_ms, kernel_name, split=()):
        tree_out = call("tree")
        t = dv.in_turns(torch, names, call, kernel_name, bound_ms)
        print(f"---- {kernel} {label} on {card}: bound {bound_ms:.4f} ms")
        for n in names:
            out = call(n)
            errs = compare(out)
            r = {"ms": t[n][0], "device_ms": t[n][1], "runs": t[n][2], "bound_ms": bound_ms, **errs,
                 "bit_identical_to_tree": all(torch.equal(a, b) for a, b in zip(out, tree_out))}
            if split:
                r["device_ms_by_kernel"] = cs.device_ms_by_kernel(torch, lambda: call(n), split,
                                                                  n=10)
            readings.setdefault(n, {})[f"{kernel} {label}"] = r
            print(f"{n}: {r['ms']:.4f} ms back to back, device {cs.fmt_ms(r['device_ms'])} ms"
                  + "".join(f" ({k} {v:.4f})" for k, v in r.get("device_ms_by_kernel", {}).items())
                  + f", runs {r['runs']}, " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
                  + f", bit-identical to the tree: {r['bit_identical_to_tree']}")

    # ---- ssd_scan at Mamba2-2.7B's admission lengths
    H, Pd, N = 80, 64, 128
    for S in (64, 256, 544, 1024) if "ssd_scan" in want else ():
        x, dt, A, Bm, Cm, D = cs._ssd_case(torch, g, 1, S, H, Pd, 1, N, -4.0)
        A32, D32 = A.float().contiguous(), D.float().contiguous()
        want_y, want_h = ref.ssd_scan_ref(x, dt, A, Bm, Cm, D, chunk=128)
        top = want_y.float().abs().amax(-1, keepdim=True).clamp_min(1e-30)
        step = torch.exp2(torch.floor(torch.log2(top)) - 7)

        def scan(n):
            y = torch.empty((1, S, H, Pd), dtype=torch.bfloat16, device=dev)
            h = torch.empty((1, H, Pd, N), dtype=torch.float32, device=dev)
            err = libs["ssd_scan"][n].ssd_scan(
                x.data_ptr(), dt.data_ptr(), A32.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                D32.data_ptr(), y.data_ptr(), h.data_ptr(), x.stride(0), x.stride(1), x.stride(2),
                Bm.stride(0), Bm.stride(1), Bm.stride(2), dt.stride(0), dt.stride(1), 1, S, H, Pd,
                1, N, stream)
            if err:
                raise RuntimeError(f"{n}: ssd_scan launch failed ({err})")
            return y, h

        def compare(out):
            y, h = out
            return {"y_bf16_steps": ((y.float() - want_y.float()).abs() / step).max().item(),
                    "state_err": cs.row_rel_err(h, want_h, dims=2)}

        bound_ms = cs.ssd_bound(1, S, H, Pd, 1, N)[0]
        report("ssd_scan", f"S={S}", order["ssd_scan"], scan, compare, bound_ms, "ssd_scan_kernel")

    # ---- paged_prefill at Qwen2-7B's chunk and bucket over chip_smoke's pool
    H, Hkv, D, page, npages, n_tables = 28, 4, 128, 16, 4097, 128
    prefill_shapes = {"512-token chunk at start 512": (512, 512, 512),
                      "64-token bucket, 37 valid, at start 1000": (64, 1000, 37)}
    if "paged_prefill" in want:
        k_pool, v_pool = randn(npages, page, Hkv, D), randn(npages, page, Hkv, D)
        bt = cs._paged_layout(torch, np, np.random.default_rng(10), [2048], page, n_tables,
                              npages, dev)
    for label, (S, start, valid) in prefill_shapes.items() if "paged_prefill" in want else ():
        q = randn(1, S, H, D)
        st = torch.tensor([start], dtype=torch.int32, device=dev)
        ln = torch.tensor([start + valid], dtype=torch.int32, device=dev)
        want = ref.paged_prefill_attention_ref(q, k_pool, v_pool, bt, st, ln)

        def prefill(n):
            out = torch.empty_like(q)
            lib = libs["paged_attention"][n]
            common = (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), bt.data_ptr(),
                      st.data_ptr(), ln.data_ptr(), out.data_ptr(), 1, S, H, Hkv, D, page, n_tables)
            if n == "parent":
                err = lib.paged_flash_prefill(*common, *q.stride()[:3], *k_pool.stride()[:3],
                                              bt.stride(0), *out.stride()[:3], 0.0, stream)
            else:
                err = lib.paged_flash_prefill(*common, npages, *q.stride()[:3], bt.stride(0),
                                              *out.stride()[:3], 0.0, stream)
            if err:
                raise RuntimeError(f"{n}: paged_prefill launch failed ({err})")
            return (out,)

        visible = sum(min(start + i + 1, start + valid) for i in range(S))
        nbytes = 2 * S * H * D * 2 + 2 * (start + valid) * Hkv * D * 2 + bt.numel() * 4 + 8
        bound_ms = cs.bound(4 * H * D * visible, nbytes)[0]
        report("paged_prefill", label, order["paged_attention"], prefill,
               lambda out: {"row_err": cs.row_rel_err(out[0], want, dims=2)}, bound_ms,
               "paged_prefill")

    # ---- flash_attention_fwd, parent and tree: the same bits
    from repro_torch.kernels.flash_attention import _geometry
    shapes = {"qwen2-7b prefill": (1, 1024, 28, 4, 128, 1),
              "esm2-650m serving": (32, 1024, 20, 20, 64, 0)}
    for label, (B, S, H, Hkv, D, causal) in shapes.items() if "flash_attention_fwd" in want else ():
        q, k, v = randn(B, S, H, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D)
        geo = _geometry(q, k, v)
        want, _ = ref.attention_ref(q, k, v, causal=bool(causal))

        def fwd(n):
            out = torch.empty_like(q)
            lse = torch.empty((B * H, S), dtype=torch.float32, device=dev)
            err = libs["flash_attention_fwd"][n].flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), 0, B, S,
                S, H, Hkv, D, ctypes.addressof(geo), *out.stride()[:3], causal, 0, 0.0, 0, stream)
            if err:
                raise RuntimeError(f"{n}: flash_attention_fwd launch failed ({err})")
            return out, lse

        bound_ms = cs.bound(*cs.attention_work(B, S, S, H, Hkv, D, {"causal": bool(causal)}, 2))[0]
        report("flash_attention_fwd", label, order["flash_attention_fwd"], fwd,
               lambda out: {"row_err": cs.row_rel_err(out[0], want, dims=2)}, bound_ms,
               "flash_attention_fwd")
        del q, k, v

    if "ssd_scan_bwd" in want:
        bwd_section(torch, cs, libs["ssd_scan_bwd"], order["ssd_scan_bwd"], report, g, dev)

    out = cs.ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "prefill_variants.json").write_text(json.dumps(readings, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
