#!/usr/bin/env python3
"""Time the prefill kernels -- the SSD chunked scan and the paged chunk
prefill -- against the parent's and against variants of their designs, and
hold the dense attention forward (whose consumer body the paged prefill
shares) to the parent's bits.

    python3 prefill_variants.py --save-parent REV   # in a git checkout
    python3 prefill_variants.py [--parent [DIR]]     # on one card

``--save-parent REV`` writes ``git show REV:`` of ``csrc/ssd_scan.cu``,
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
  8 rows" (the swizzle atom).

Each library runs in turns (the order and then back, so two profiler
windows each) at each shape: CUDA events over back-to-back calls and the
profiler's device time (``chip_smoke.device_ms``), beside the bound and
the output against the plain version and against the tree's bits.
ssd_scan at Mamba2-2.7B's admission lengths S = 64, 256, 544 and 1024
(B 1, H 80, P 64, N 128); paged_prefill at Qwen2-7B's 512-token chunk at
start 512 and at the 64-token bucket at start 1000 (pages of 16, chip_smoke's
pool); flash_attention_fwd, parent and tree, at Qwen2's prefill and ESM-2's
serving shapes.  Writes the readings to ``chiprun_out/prefill_variants.json``.
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
    "ssd_scan.cu", "paged_attention.cu", "flash_attention_fwd.cu", "mma.cuh", "hopper.cuh",
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

    if not torch.cuda.is_available():
        print("prefill_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ref

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    parent = Path(args.parent).resolve() if args.parent else None
    jobs = _build.start_builds(["ssd_scan", "paged_attention", "flash_attention_fwd"])
    s_jobs = dv.build("ssd_scan", SSD_VARIANTS, parent)
    p_jobs = dv.build("paged_attention", PAGED_VARIANTS, parent)
    f_jobs = dv.build("flash_attention_fwd", {}, parent)
    _build.finish_builds(jobs)
    P, I, I64, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    libs = {}
    for kern, more in (("ssd_scan", dv.finish(s_jobs)), ("paged_attention", dv.finish(p_jobs)),
                       ("flash_attention_fwd", dv.finish(f_jobs))):
        libs[kern] = {}
        for label, so in {"tree": _build.lib_path(kern), **more}.items():
            lib = ctypes.CDLL(str(so))
            if kern == "ssd_scan":
                lib.ssd_scan.argtypes = [P] * 8 + [I64] * 8 + [I] * 6 + [P]
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

    def report(kernel, label, names, call, compare, bound_ms, kernel_name):
        tree_out = call("tree")
        t = dv.in_turns(torch, names, call, kernel_name, bound_ms)
        print(f"---- {kernel} {label} on {card}: bound {bound_ms:.4f} ms")
        for n in names:
            out = call(n)
            errs = compare(out)
            r = {"ms": t[n][0], "device_ms": t[n][1], "runs": t[n][2], "bound_ms": bound_ms, **errs,
                 "bit_identical_to_tree": all(torch.equal(a, b) for a, b in zip(out, tree_out))}
            readings.setdefault(n, {})[f"{kernel} {label}"] = r
            print(f"{n}: {r['ms']:.4f} ms back to back, device {cs.fmt_ms(r['device_ms'])} ms, "
                  f"runs {r['runs']}, " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
                  + f", bit-identical to the tree: {r['bit_identical_to_tree']}")

    # ---- ssd_scan at Mamba2-2.7B's admission lengths
    H, Pd, N = 80, 64, 128
    for S in (64, 256, 544, 1024):
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
    k_pool, v_pool = randn(npages, page, Hkv, D), randn(npages, page, Hkv, D)
    bt = cs._paged_layout(torch, np, np.random.default_rng(10), [2048], page, n_tables, npages, dev)
    for label, (S, start, valid) in {"512-token chunk at start 512": (512, 512, 512),
                                     "64-token bucket, 37 valid, at start 1000": (64, 1000, 37)
                                     }.items():
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
    for label, (B, S, H, Hkv, D, causal) in shapes.items():
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

    out = cs.ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "prefill_variants.json").write_text(json.dumps(readings, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
