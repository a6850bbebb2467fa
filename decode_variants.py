#!/usr/bin/env python3
"""Time the decode step's sampling and paged flash-decoding kernels against
the parent's and against variants of their designs, and flash-decoding
against the parent's, at Qwen2-7B's (and Scout's and Mamba2's) decode
shapes.

    python3 decode_variants.py --save-parent REV   # in a git checkout
    python3 decode_variants.py [--parent [DIR]]     # on one card

``--save-parent REV`` writes ``git show REV:`` of ``csrc/sampling.cu``,
``csrc/paged_attention.cu``, ``csrc/flash_decode.cu``, the headers they
include (``mma.cuh``, ``decode_split.cuh``, ``attention_fwd.cuh``,
``hopper.cuh``), ``kernels/sampling.py`` and ``kernels/paged_attention.py``
into DIR (by default ``.chip_archive/parent/``: ignored by git, skipped by
pytest, carried by a copy of the tree) and stops.  On the card,
``--parent`` adds those sources as the library "parent" of each kernel
(built with its own headers beside it, which are found before the tree's:
a header that another header includes resolves beside it too, so no
header is included from both places), and times those
wrappers' host path (they launch the tree's kernels, whose C entry points
are unchanged).

Needs one card.  Each variant is a textual edit of a source or header,
written with the other edited files into a directory of its own under
``kernels/build/variants/`` (the tree is not changed) and built with the
tree's headers behind it, one nvcc each, all started together:

- fused_sample: "cluster 2", "cluster 3", "cluster 8" (blocks a row; the
  tree: 4), "levels 1", "levels 4", "levels 5" (bisection levels a pass,
  with 1024, 512 and 256 threads a block; the tree: 3, 1024 threads),
  "512 threads" (levels 3);
- paged_decode: "ring 1 stage", "ring 3 stages" (each warp's ring of
  16-key stages; the tree: 2, in ``decode_split.cuh``, which flash_decode
  shares), "rows one by one at page 16" (each row's address looked up by
  its own lane, the path of pages that are not a multiple of 16);
- the fused insert, timed with the insert only: "insert loads after the
  copies" (the writing lane loads its piece of the new row after the
  stage's copies are issued; the tree: before), "swap only, no insert
  store" (the new row read from k_new / v_new, nothing stored: the
  insert's cost without its store; its pools then differ).

The decode step's K/V insert is timed with the parent: the parent's pair
(``paged_kv_write``, then ``paged_flash_decode``) and its decode alone
against the tree's pair, the tree's decode with the insert fused
(``paged_decode_append``) and its decode alone, each through its library's
C entry points, in turns twice, at Qwen2's decode shape with slot 0 idle
and slot 3 masked to the null page (``chip_smoke._append_case``): whether
the fused launch's live rows and pools (outside the null page) equal the
parent pair's, and the insert's device time inside the fused launch (fused
minus alone, each turn).

Each library runs in turns (the order and then back) at each shape: CUDA
events over back-to-back calls and the profiler's device time
(``chip_smoke.device_ms``), beside the bound, whether its output is the
plain version's (tokens equal and logp within 1e-4; rows within 2e-2 of
each row's max) and whether it equals the tree's bit for bit.  The
sampler at (32, 152064) with chip_smoke's mix of rows, all greedy and all
sampled, and with the mix at Scout's 202 240 and Mamba2's 50 432 columns
(parent and tree); paged_decode at Qwen2's decode shape over chip_smoke's
pool, split into its two kernels; the insert as above; flash_decode at
Qwen2's and Scout's decode shapes (parent and tree) and its bits on
``chip_smoke.flash_decode_bits``'s inputs; then each wrapper's host µs a
call.
Writes the readings to ``chiprun_out/decode_variants.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import chip_smoke as cs

PARENT_FILES = {name: f"src/repro_torch/kernels/csrc/{name}"
                for name in ("sampling.cu", "paged_attention.cu", "flash_decode.cu", "mma.cuh",
                             "decode_split.cuh", "attention_fwd.cuh", "hopper.cuh")}
PARENT_FILES.update({f"{m}.py": f"src/repro_torch/kernels/{m}.py"
                     for m in ("sampling", "paged_attention")})
PARENT_DIR = cs.ROOT / ".chip_archive" / "parent"
THREADS = "constexpr int kThreads = kLevels <= 3 ? 1024 : kLevels == 4 ? 512 : 256;"
SAMPLE_VARIANTS = {
    "cluster 2": [("sampling.cu", "constexpr int kCluster = 4;", "constexpr int kCluster = 2;")],
    "cluster 3": [("sampling.cu", "constexpr int kCluster = 4;", "constexpr int kCluster = 3;")],
    "cluster 8": [("sampling.cu", "constexpr int kCluster = 4;", "constexpr int kCluster = 8;")],
    "levels 1": [("sampling.cu", "constexpr int kLevels = 3;", "constexpr int kLevels = 1;")],
    "levels 4": [("sampling.cu", "constexpr int kLevels = 3;", "constexpr int kLevels = 4;")],
    "levels 5": [("sampling.cu", "constexpr int kLevels = 3;", "constexpr int kLevels = 5;")],
    "512 threads": [("sampling.cu", THREADS, "constexpr int kThreads = 512;")],
}
INSERT_LOADS = """    if (ins) {
      dst = (lane < kPerRow ? app.k_pool : app.v_pool) + (long long)app.page_idx[b] * page_stride +
            (long long)app.row[b] * row_stride + head + col;
      piece = *reinterpret_cast<const uint4*>((lane < kPerRow ? kn : vn) + col);
    }
"""
INSERT_STORE = "    if (ins) *reinterpret_cast<uint4*>(dst) = piece;\n"
# the fused insert's variants, timed only with the insert (csrc/paged_attention.cu)
INSERT_VARIANTS = {
    "insert loads after the copies": [("paged_attention.cu", INSERT_LOADS, ""),
                                      ("paged_attention.cu", INSERT_STORE,
                                       INSERT_LOADS + INSERT_STORE)],
    "swap only, no insert store": [("paged_attention.cu", INSERT_STORE, "")],
}
PAGED_VARIANTS = {
    "ring 1 stage": [("decode_split.cuh", "constexpr int kStages = 2;", "constexpr int kStages = 1;")],
    "ring 3 stages": [("decode_split.cuh", "constexpr int kStages = 2;",
                       "constexpr int kStages = 3;")],
    "rows one by one at page 16": [("paged_attention.cu",
                                    "const bool by_row = pl.page % decode::kSub != 0;",
                                    "const bool by_row = true;")],
    **INSERT_VARIANTS,
}


def save_parent(rev: str, out: Path, files=None) -> None:
    """``git show REV:`` of each of ``files`` ({name: path in the repo};
    by default this script's) into ``out``."""
    files = files or PARENT_FILES
    out.mkdir(parents=True, exist_ok=True)
    for name, path in files.items():
        text = subprocess.run(["git", "show", f"{rev}:{path}"], cwd=cs.ROOT, capture_output=True,
                              text=True, check=True).stdout
        (out / name).write_text(text)
    print(f"wrote {rev}'s {', '.join(files)} into {out}")


def build(name, variants, parent=None):
    """One nvcc per variant of ``csrc/<name>.cu`` (and the parent's
    source), all started together -> {label: (library, running job)}."""
    from repro_torch.kernels import _build

    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {}
    for i, (label, edits) in enumerate(variants.items()):
        texts = {}
        for fname, old, new in edits:
            text = texts.get(fname) or (_build.CSRC / fname).read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"variant {label!r}: {old!r} is not in {fname} once")
            texts[fname] = text.replace(old, new)
        texts.setdefault(f"{name}.cu", (_build.CSRC / f"{name}.cu").read_text())
        d = out_dir / f"{name}_{i}"
        d.mkdir(parents=True, exist_ok=True)
        for fname, text in texts.items():
            (d / fname).write_text(text)
        sources[label] = d / f"{name}.cu"
    if parent:
        sources["parent"] = parent / f"{name}.cu"
    jobs = {}
    for label, cu in sources.items():
        so = out_dir / f"{name}_{''.join(ch if ch.isalnum() else '_' for ch in label)}.so"
        cmd = [_build.nvcc(), *_build.FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)]
        jobs[label] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    return jobs


def finish(jobs):
    """{label: library path} of the jobs of ``build`` that built."""
    built = {}
    for label, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:   # a variant that does not build is reported and left out
            print(f"variant {label!r} did not build:\n{log}")
            if label == "parent":
                raise RuntimeError("the parent's source did not build")
        else:
            built[label] = so
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


def in_turns(torch, names, call, kernel, bound_ms, rounds: int = 1):
    """{name: (mean ms back to back, mean device ms, runs)}: each library
    timed in the order of ``names`` and then back, ``rounds`` times; the
    device time sums the kernels whose names hold ``kernel`` (a name or a
    tuple of names)."""
    runs = {n: [] for n in names}
    kernels = (kernel,) if isinstance(kernel, str) else kernel
    for n in (list(names) + list(names)[::-1]) * rounds:
        runs[n].append((cs.time_ms(torch, lambda: call(n)),
                        cs.device_ms(torch, lambda: call(n), *kernels, floor=bound_ms)))
    out = {}
    for n, r in runs.items():
        devs = [t[1] for t in r if t[1]]
        out[n] = (sum(t[0] for t in r) / len(r), sum(devs) / len(devs) if devs else None, r)
    return out


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
        print("decode_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import sampling as sp

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    parent = Path(args.parent).resolve() if args.parent else None
    jobs = _build.start_builds(["sampling", "paged_attention", "flash_decode"])
    s_jobs = build("sampling", SAMPLE_VARIANTS, parent)
    p_jobs = build("paged_attention", PAGED_VARIANTS, parent)
    f_jobs = build("flash_decode", {}, parent)
    _build.finish_builds(jobs)
    P, I, I64, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    libs = {}
    for kern, more in (("sampling", finish(s_jobs)), ("paged_attention", finish(p_jobs)),
                       ("flash_decode", finish(f_jobs))):
        paths = {"tree": _build.lib_path(kern), **more}
        libs[kern] = {}
        for label, so in paths.items():
            lib = ctypes.CDLL(str(so))
            if kern == "sampling":
                lib.fused_sample.argtypes = [P, I, I, I64] + [P] * 7 + [P]
            elif kern == "paged_attention":
                lib.paged_flash_decode.argtypes = [P] * 9 + [I] * 6 + [I64] * 8 + [F32, P]
                lib.paged_decode_splits.argtypes = [I]
                lib.paged_kv_write.argtypes = [P] * 6 + [I] * 3 + [I64] * 7 + [P]
                if hasattr(lib, "paged_decode_append"):
                    lib.paged_decode_append.argtypes = [P] * 13 + [I] * 6 + [I64] * 12 + [F32, P]
            else:
                lib.flash_decode.argtypes = [P] * 8 + [I] * 5 + [I64] * 10 + [F32, P]
                lib.flash_decode_splits.argtypes = [I]
            libs[kern][label] = lib
    order = {k: ["parent"] * bool(parent) + ["tree"] + [n for n in v if n not in ("parent", "tree")]
             for k, v in libs.items()}
    stream = torch.cuda.current_stream().cuda_stream
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=g, device=dev) * scale + shift).to(dtype)

    def sample(label, x, temp, top_k, top_p, seed, step):
        B, V = x.shape
        tok = torch.empty((B,), dtype=torch.int32, device=dev)
        logp = torch.empty((B,), dtype=torch.float32, device=dev)
        err = libs["sampling"][label].fused_sample(
            x.data_ptr(), B, V, x.stride(0), temp.data_ptr(), top_k.data_ptr(), top_p.data_ptr(),
            seed.data_ptr(), step.data_ptr(), tok.data_ptr(), logp.data_ptr(), stream)
        if err:
            raise RuntimeError(f"{label}: fused_sample launch failed ({err})")
        return tok, logp

    readings = {"card": card}

    # ---- fused_sample
    for label, (B, V, rows, how, names) in {
        "qwen2-7b (32, 152064), the mix": (32, 152064, cs.SAMPLE_MIX, None, order["sampling"]),
        "qwen2-7b (32, 152064), all greedy": (32, 152064, cs.SAMPLE_MIX, 0.0, order["sampling"][:2]),
        "qwen2-7b (32, 152064), all sampled": (32, 152064, cs.SAMPLE_MIX, 0.8,
                                               order["sampling"][:2]),
        "scout (32, 202240), the mix": (32, 202240, cs.SAMPLE_MIX, None, order["sampling"][:2]),
        "mamba2 (32, 50432), the mix": (32, 50432, cs.SAMPLE_MIX, None, order["sampling"][:2]),
    }.items():
        a = list(cs.sample_inputs(torch, randn, B, V, rows))
        if how is not None:
            a[1] = torch.full_like(a[1], how)
        bound_ms, bound_by = cs.bound(0, B * V * 2 + B * 20 + B * 8)
        r_tok, r_logp = ref.sample_ref(*a)
        tree = sample("tree", *a)
        t = in_turns(torch, names, lambda n: sample(n, *a), "fused_sample", bound_ms)
        print(f"---- fused_sample {label} on {card}: bound {bound_ms:.5f} ms by {bound_by}")
        for n in names:
            tok, logp = sample(n, *a)
            r = {"ms": t[n][0], "device_ms": t[n][1], "runs": t[n][2], "bound_ms": bound_ms,
                 "tokens_equal_plain": int((tok == r_tok).sum()),
                 "logp_err": (logp - r_logp).abs().max().item(),
                 "bit_identical_to_tree": torch.equal(tok, tree[0]) and torch.equal(logp, tree[1])}
            if n != "parent":    # the parent runs a block a row
                r["clusters_resident"] = libs["sampling"][n].fused_sample_max_clusters(V)
            readings.setdefault(n, {})[f"fused_sample {label}"] = r
            print(f"{n}: {r['ms']:.4f} ms back to back, device {cs.fmt_ms(r['device_ms'])} ms, runs "
                  f"{r['runs']}, tokens equal to the plain version's {r['tokens_equal_plain']}/{B}, "
                  f"logp err {r['logp_err']:.3g}, bit-identical to the tree: "
                  f"{r['bit_identical_to_tree']}, clusters resident {r.get('clusters_resident')}")

    # ---- paged_decode at Qwen2-7B's decode shape over chip_smoke's pool
    B, cap, H, Hkv, D, page, npages = 32, 2048, 28, 4, 128, 16, 4097
    lens = np.random.default_rng(1).integers(0, cap + 1, size=B)
    lens[:3] = [0, 1, cap]
    bt = cs._paged_layout(torch, np, np.random.default_rng(9), lens, page, cap // page, npages, dev)
    lengths = torch.as_tensor(lens, dtype=torch.int32, device=dev)
    q = randn(B, 1, H, D)
    k_pool, v_pool = randn(npages, page, Hkv, D), randn(npages, page, Hkv, D)

    def paged(label):
        lib = libs["paged_attention"][label]
        n = B * H * lib.paged_decode_splits(cap)
        out = torch.empty((B, 1, H, D), dtype=q.dtype, device=dev)
        part = torch.empty((n * (D + 2),), dtype=torch.float32, device=dev)
        base = part.data_ptr()
        err = lib.paged_flash_decode(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                                     bt.data_ptr(), lengths.data_ptr(), out.data_ptr(), base,
                                     base + 4 * n, base + 8 * n, B, H, Hkv, D, page, cap // page,
                                     q.stride(0), q.stride(2), *k_pool.stride()[:3], bt.stride(0),
                                     out.stride(0), out.stride(2), 0.0, stream)
        if err:
            raise RuntimeError(f"{label}: paged_decode launch failed ({err})")
        return out

    live = int(lens.sum())
    nbytes = 2 * B * H * D * 2 + 2 * live * Hkv * D * 2 + B * 4 + bt.numel() * 4
    bound_ms, bound_by = cs.bound(4 * H * D * live, nbytes)
    want = ref.paged_decode_attention_ref(q, k_pool, v_pool, bt, lengths)
    tree_out = paged("tree")
    names = [n for n in order["paged_attention"] if n not in INSERT_VARIANTS]
    t = in_turns(torch, names, paged, "paged_decode", bound_ms)
    print(f"---- paged_decode at qwen2-7b's decode shape (B={B}, capacity {cap}, H={H}, Hkv={Hkv}, "
          f"D={D}, page {page}, {live} live rows) on {card}: bound {bound_ms:.4f} ms by {bound_by}")
    for n in names:
        out = paged(n)
        r = {"ms": t[n][0], "device_ms": t[n][1], "runs": t[n][2], "bound_ms": bound_ms,
             "row_err": cs.row_rel_err(out, want), "bit_identical_to_tree": torch.equal(out, tree_out)}
        if n in ("parent", "tree"):
            r["device_ms_by_kernel"] = cs.device_ms_by_kernel(torch, lambda: paged(n),
                                                              ("split_kernel", "combine_kernel"))
        readings.setdefault(n, {})["paged_decode qwen2-7b"] = r
        print(f"{n}: {r['ms']:.4f} ms back to back, device {cs.fmt_ms(r['device_ms'])} ms "
              f"({cs.per_device_ms(nbytes, r['device_ms'], 'GB/s', 1e6)}), runs {r['runs']}, row err "
              f"{r['row_err']:.3g}, bit-identical to the tree: {r['bit_identical_to_tree']}"
              + (f", by kernel {r['device_ms_by_kernel']}" if "device_ms_by_kernel" in r else ""))

    # ---- the decode step's insert: pair, fused and alone, parent and tree
    x = cs._append_case(torch, np, np.random.default_rng(12), randn, B, cap, H, Hkv, D, page,
                        npages, lens, idle=[0], masked=[3])
    q, bt, lengths, live = x["q"], x["bt"], x["lengths"], x["live"]
    kn, vn, pi, ri = x["k_new"], x["v_new"], x["pi"], x["ri"]

    def decode_call(label, kp, vp, append):
        lib = libs["paged_attention"][label]
        n = B * H * lib.paged_decode_splits(cap)
        out = torch.empty((B, 1, H, D), dtype=q.dtype, device=dev)
        part = torch.empty((n * (D + 2),), dtype=torch.float32, device=dev)
        base = part.data_ptr()
        head = [q.data_ptr(), kp.data_ptr(), vp.data_ptr(), bt.data_ptr(), lengths.data_ptr()]
        tail = [out.data_ptr(), base, base + 4 * n, base + 8 * n, B, H, Hkv, D, page, cap // page,
                q.stride(0), q.stride(2), *kp.stride()[:3], bt.stride(0), out.stride(0),
                out.stride(2)]
        if append:
            err = lib.paged_decode_append(*head, kn.data_ptr(), vn.data_ptr(), pi.data_ptr(),
                                          ri.data_ptr(), *tail, kn.stride(0), kn.stride(2),
                                          vn.stride(0), vn.stride(2), 0.0, stream)
        else:
            err = lib.paged_flash_decode(*head, *tail, 0.0, stream)
        if err:
            raise RuntimeError(f"{label}: paged decode launch failed ({err})")
        return out

    def write_call(label, kp, vp):
        err = libs["paged_attention"][label].paged_kv_write(
            kp.data_ptr(), vp.data_ptr(), kn.data_ptr(), vn.data_ptr(), pi.data_ptr(),
            ri.data_ptr(), B, Hkv, D, *kp.stride()[:3], kn.stride(0), kn.stride(2), vn.stride(0),
            vn.stride(2), stream)
        if err:
            raise RuntimeError(f"{label}: paged_kv_write launch failed ({err})")

    src = "parent" if parent else "tree"
    pk, pv = x["k_pool"].clone(), x["v_pool"].clone()
    write_call(src, pk, pv)
    pair_out = decode_call(src, pk, pv, False)
    fk, fv = x["k_pool"].clone(), x["v_pool"].clone()
    fused_out = decode_call("tree", fk, fv, True)
    same = {"tree": (fused_out, fk, fv)}
    for v in INSERT_VARIANTS:
        if v in libs["paged_attention"]:
            vk, vv = x["k_pool"].clone(), x["v_pool"].clone()
            same[v] = (decode_call(v, vk, vv, True), vk, vv)
    same = {n: {"live rows": torch.equal(o[live], pair_out[live]),
                "pools outside the null page": torch.equal(a[1:], pk[1:]) and torch.equal(
                    b[1:], pv[1:])} for n, (o, a, b) in same.items()}

    modes = {f"{src} pair": (src, "pair"), f"{src} alone": (src, "alone")} if parent else {}
    modes.update({"tree pair": ("tree", "pair"), "tree fused": ("tree", "fused"),
                  "tree alone": ("tree", "alone")})
    modes.update({f"{v} fused": (v, "fused") for v in INSERT_VARIANTS
                  if v in libs["paged_attention"]})

    def insert(label):
        lib, mode = modes[label]
        if mode == "pair":
            write_call(lib, fk, fv)
            return decode_call(lib, fk, fv, False)
        return decode_call(lib, fk, fv, mode == "fused")

    names = list(modes)
    live_rows = x["n_live"]
    nbytes = 2 * B * H * D * 2 + 2 * live_rows * Hkv * D * 2 + B * 4 + bt.numel() * 4
    bound_ms, bound_by = cs.bound(4 * H * D * live_rows, nbytes)
    t = in_turns(torch, names, insert, ("paged_kv_write", "paged_decode"), bound_ms, rounds=2)
    diffs = [f[1] - a[1] for f, a in zip(t["tree fused"][2], t["tree alone"][2])
             if f[1] and a[1]]
    readings["paged insert qwen2-7b"] = {
        "bits equal to the pair's": same, "bound_ms": bound_ms, "bound_by": bound_by,
        "live_rows": live_rows, "insert_device_ms_turns": diffs,
        **{n: {"ms": t[n][0], "device_ms": t[n][1], "runs": t[n][2]} for n in names}}
    print(f"---- the decode step's insert at qwen2-7b's decode shape ({live_rows} live rows, slot 0 "
          f"idle, slot 3 masked) on {card}: the decode's bound {bound_ms:.4f} ms by {bound_by}; "
          f"each fused launch = the {src}'s pair: {same}")
    for n in names:
        print(f"{n}: {t[n][0]:.4f} ms back to back, device {cs.fmt_ms(t[n][1])} ms, runs {t[n][2]}")
    print(f"the insert inside the fused launch (fused - alone, device ms, each turn): "
          f"{[round(d, 5) for d in diffs]}")
    paged_in = (q, fk, fv, bt, lengths)    # the host section times the wrappers on these

    # ---- flash_decode, parent and tree, at the decode shapes
    rng = np.random.default_rng(1)
    for label, (B, T, H, Hkv, D) in {"qwen2-7b": (32, 2048, 28, 4, 128),
                                     "scout": (32, 2048, 40, 8, 128)}.items():
        lens = rng.integers(0, T + 1, size=B)
        lens[:3] = [0, 1, T]
        lengths = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        q, k, v = randn(B, 1, H, D), randn(B, T, Hkv, D), randn(B, T, Hkv, D)

        def dense(n):
            return flash_call(n, q, k, v, lengths)

        def flash_call(n, q, k, v, lengths):
            B, T, Hkv, D = k.shape
            H = q.shape[2]
            lib = libs["flash_decode"][n]
            m = B * H * lib.flash_decode_splits(T)
            out = torch.empty((B, 1, H, D), dtype=q.dtype, device=dev)
            part = torch.empty((m * (D + 2),), dtype=torch.float32, device=dev)
            base = part.data_ptr()
            err = lib.flash_decode(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                                   out.data_ptr(), base, base + 4 * m, base + 8 * m, B, T, H, Hkv, D,
                                   q.stride(0), q.stride(2), *k.stride()[:3], *v.stride()[:3],
                                   out.stride(0), out.stride(2), 0.0, stream)
            if err:
                raise RuntimeError(f"{n}: flash_decode launch failed ({err})")
            return out

        live = int(lens.sum())
        nbytes = 2 * B * H * D * 2 + 2 * live * Hkv * D * 2 + B * 4
        bound_ms, _ = cs.bound(4 * H * D * live, nbytes)
        tree_out = dense("tree")
        names = order["flash_decode"]
        t = in_turns(torch, names, dense, "flash_decode", bound_ms)
        print(f"---- flash_decode at {label}'s decode shape ({live} live rows) on {card}: bound "
              f"{bound_ms:.4f} ms")
        for n in names:
            r = {"ms": t[n][0], "device_ms": t[n][1], "runs": t[n][2], "bound_ms": bound_ms,
                 "bit_identical_to_tree": torch.equal(dense(n), tree_out)}
            readings.setdefault(n, {})[f"flash_decode {label}"] = r
            print(f"{n}: {r['ms']:.4f} ms back to back, device {cs.fmt_ms(r['device_ms'])} ms, runs "
                  f"{r['runs']}, bit-identical to the tree: {r['bit_identical_to_tree']}")
        del q, k, v
    for n in order["flash_decode"]:
        bits = cs.flash_decode_bits(torch, lambda *a, n=n: flash_call(n, *a))
        readings.setdefault(n, {})["flash_decode bits"] = bits
        print(f"flash_decode bits on chip_smoke.flash_decode_bits's inputs, {n}: {bits} "
              f"(chip_smoke holds the tree to {cs.FLASH_DECODE_BITS})")

    # ---- the host's cost of the wrappers, at the decode shapes
    x, temp, top_k, top_p, seed, step = cs.sample_inputs(torch, randn, 32, 152064, cs.SAMPLE_MIX)
    q, k_pool, v_pool, bt, lengths = paged_in
    fn = sp._fn()
    tok = torch.empty((32,), dtype=torch.int32, device=dev)
    logp = torch.empty((32,), dtype=torch.float32, device=dev)
    raw = [x.data_ptr(), 32, 152064, x.stride(0), temp.data_ptr(), top_k.data_ptr(),
           top_p.data_ptr(), seed.data_ptr(), step.data_ptr(), tok.data_ptr(), logp.data_ptr(),
           stream]
    pfn = pa._decode_fns_c()[0]
    out = torch.empty((32, 1, 28, 128), dtype=torch.bfloat16, device=dev)
    part = _build.scratch(0, 32 * 28 * 8 * 130)
    praw = [q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), bt.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), part.data_ptr(), part.data_ptr() + 4 * 7168,
            part.data_ptr() + 8 * 7168, 32, 28, 4, 128, 16, 128, q.stride(0), q.stride(2),
            *k_pool.stride()[:3], bt.stride(0), out.stride(0), out.stride(2), 0.0, stream]
    parts = {
        "an empty Python call": lambda: None,
        "x.new_empty((32,), int32)": lambda: x.new_empty((32,), dtype=torch.int32),
        "torch._C._cuda_getCurrentRawStream": lambda: torch._C._cuda_getCurrentRawStream(0),
        "fused_sample: the ctypes call and launch alone": lambda: fn(*raw),
        "paged_decode: the ctypes call and launch alone": lambda: pfn(*praw),
        "fused_sample (the tree's wrapper)": lambda: sp.fused_sample(x, temp, top_k, top_p, seed,
                                                                    step),
        "paged_decode (the tree's wrapper)": lambda: pa.paged_decode(q, k_pool, v_pool, bt,
                                                                    lengths),
        "paged_decode with the insert (the tree's wrapper)": lambda: pa.paged_decode(
            q, k_pool, v_pool, bt, lengths, k_new=kn, v_new=vn, page_idx=pi, row=ri),
        "paged_kv_write (the tree's wrapper)": lambda: pa.paged_kv_write(k_pool, v_pool, kn, vn,
                                                                        pi, ri),
    }
    if parent:
        for mod in ("sampling", "paged_attention"):
            spec = importlib.util.spec_from_file_location(f"parent_{mod}", parent / f"{mod}.py")
            m = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(m)
            if mod == "sampling":
                parts["fused_sample (the parent's wrapper)"] = (
                    lambda m=m: m.fused_sample(x, temp, top_k, top_p, seed, step))
            else:
                parts["paged_decode (the parent's wrapper)"] = (
                    lambda m=m: m.paged_decode(q, k_pool, v_pool, bt, lengths))
                parts["paged_kv_write (the parent's wrapper)"] = (
                    lambda m=m: m.paged_kv_write(k_pool, v_pool, kn, vn, pi, ri))
    host = {name: per_call_us(torch, f, n=500) for name, f in parts.items()}
    readings["host µs a call"] = host
    print(f"---- host µs a call on {card}: " + ", ".join(f"{k} {v:.2f}" for k, v in host.items()))

    out = cs.ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "decode_variants.json").write_text(json.dumps(readings, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
