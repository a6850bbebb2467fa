#!/usr/bin/env python3
"""Build variants of the flash-attention forward and print what each does
to accuracy, time and the Llama-4-Scout route check of ``chip_smoke.py``.

    python3 attention_variants.py [--parent PATH] [--no-route]

Needs one card.  Each variant is a textual edit of
``csrc/flash_attention_fwd.cu`` built into its own library under
``kernels/build/variants/`` (the source in the tree is not changed):

- "128-key tiles at D 128": the key tile the D = 64 path takes, at D = 128
  too (the tree takes 64 there, the step of the mma.sync kernel it
  replaced);
- "exp2f for 2^x": CUDA's exp2f in place of ex2.approx.ftz.

For the tree's kernel and each variant it prints the share of output and
lse elements that differ from the tree's (bf16 and fp16, D = 128 at
Scout's and Qwen2's prefill shapes, D = 64 at ESM-2's), the RMS error of
the output and lse against an fp64 reference (three seeds each), the
device time at the shapes ``chip_smoke.ATTN_SHAPES`` times, and, unless
``--no-route``, the Scout generation phase's route check with the
variant's library swapped in for the wrapper's (``moe_phase``: the
largest router margin among the decisions where the plain route's own
router parts from the kernel route's, held to 0.1). ``--parent PATH``
adds a kernel with the parent commit's C interface (q, k, v, out strides
in elements), e.g. ``git show <commit>:src/repro_torch/kernels/csrc/
flash_attention_fwd.cu``, to the bit and accuracy comparisons.  Writes the
readings to ``chiprun_out/attention_variants.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import gc
import json
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

VARIANTS = {
    "128-key tiles at D 128": ("  return D == 64 ? 128 : 64;", "  return 128;"),
    "exp2f for 2^x": ('  float y;\n  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));\n'
                      '  return y;', "  return exp2f(x);"),
}

# (B, S, H, Hkv, D, kwargs) compared bit for bit and against fp64
SHAPES = {
    "scout prefill 887": (1, 887, 40, 8, 128, dict(causal=True, window=8192)),
    "scout prefill 66": (1, 66, 40, 8, 128, dict(causal=True, window=8192)),
    "qwen2 prefill 1024": (1, 1024, 28, 4, 128, dict(causal=True)),
    "esm2 B 2": (2, 1024, 20, 20, 64, dict(causal=False)),
}


def build(parent):
    """One nvcc per variant (and the parent), all started together ->
    {name: library path}."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / "flash_attention_fwd.cu").read_text()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {}
    for i, (name, (old, new)) in enumerate(VARIANTS.items()):
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: the edited text is not in the source once")
        cu = out_dir / f"flash_attention_fwd_variant{i}.cu"
        cu.write_text(src.replace(old, new))
        sources[name] = cu
    if parent:
        sources["parent"] = Path(parent).resolve()
    jobs = {}
    for i, (name, cu) in enumerate(sources.items()):
        so = out_dir / f"variant{i}.so"
        cmd = [_build.nvcc(), *_build.FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True))
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} did not build:\n{log}")
    return {name: so for name, (so, _) in jobs.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("attention_variants: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default="")
    ap.add_argument("--no-route", action="store_true")
    args = ap.parse_args()

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.finish_builds(_build.start_builds(["flash_attention_fwd", "flash_decode", "sampling",
                                              "grouped_matmul"]))
    libs = {"tree": _build.lib_path("flash_attention_fwd"), **build(args.parent)}
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fns = {}
    for name, so in libs.items():
        fn = ctypes.CDLL(str(so)).flash_attention_fwd
        strides = 12 if name == "parent" else 3
        fn.argtypes = ([P] * 5 + [I] * 7 + ([] if name == "parent" else [P]) + [I64] * strides
                       + [I, I, ctypes.c_float, I, P])
        fn.restype = I
        fns[name] = fn

    def run(name, q, k, v, causal=False, window=0):
        B, S, H, D = q.shape
        T, Hkv = k.shape[1], k.shape[2]
        o = torch.empty_like(q)
        lse = torch.empty(B * H, S, device=q.device)
        head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                int(q.dtype == torch.float16), B, S, T, H, Hkv, D)
        tail = (int(causal), int(window), 0.0, 0, torch.cuda.current_stream().cuda_stream)
        if name == "parent":
            err = fns[name](*head, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                            *o.stride()[:3], *tail)
        else:
            geo = fa._geometry(q, k, v)
            err = fns[name](*head, ctypes.addressof(geo), *o.stride()[:3], *tail)
        if err:
            raise RuntimeError(f"{name}: launch failed ({err})")
        return o, lse

    def ref64(q, k, v, causal=False, window=0):
        B, S, H, D = q.shape
        T, Hkv = k.shape[1], k.shape[2]
        kf = k.double().repeat_interleave(H // Hkv, 2)
        vf = v.double().repeat_interleave(H // Hkv, 2)
        s = torch.einsum("bshd,bthd->bhst", q.double(), kf) / D ** 0.5
        if causal:
            s = s.masked_fill(torch.ones(S, T, dtype=torch.bool, device=q.device).triu(1),
                              float("-inf"))
        out = torch.einsum("bhst,bthd->bshd", torch.softmax(s, -1), vf)
        return out, torch.logsumexp(s, -1).reshape(B * H, S)

    g = torch.Generator(device="cuda").manual_seed(0)
    readings = {name: {} for name in fns}
    for label, (B, S, H, Hkv, D, kw) in SHAPES.items():
        for dt in (torch.bfloat16, torch.float16):
            q = torch.randn(B, S, H, D, generator=g, device="cuda").to(dt)
            k = torch.randn(B, S, Hkv, D, generator=g, device="cuda").to(dt)
            v = torch.randn(B, S, Hkv, D, generator=g, device="cuda").to(dt)
            want = run("tree", q, k, v, **kw)
            for name in fns:
                o, lse = run(name, q, k, v, **kw)
                torch.cuda.synchronize()
                d_out = (o != want[0]).double().mean().item()
                d_lse = (lse != want[1]).double().mean().item()
                readings[name][f"{label} {str(dt)[6:]}: differing from the tree"] = [d_out, d_lse]
                print(f"{name}, {label} {str(dt)[6:]}: output elements differing from the tree's "
                      f"{d_out:.3e}, lse {d_lse:.3e}")
        errs = {name: [0.0, 0.0] for name in fns}
        for _ in range(3):
            q = torch.randn(B, S, H, D, generator=g, device="cuda").bfloat16()
            k = torch.randn(B, S, Hkv, D, generator=g, device="cuda").bfloat16()
            v = torch.randn(B, S, Hkv, D, generator=g, device="cuda").bfloat16()
            w_out, w_lse = ref64(q, k, v, **kw)
            for name in fns:
                o, lse = run(name, q, k, v, **kw)
                errs[name][0] += (o.double() - w_out).pow(2).mean().item() / 3
                errs[name][1] += (lse.double() - w_lse).pow(2).mean().item() / 3
        for name, (e_out, e_lse) in errs.items():
            readings[name][f"{label} bf16: rms error against fp64"] = [e_out ** 0.5, e_lse ** 0.5]
            print(f"{name}, {label} bf16 on {card}: RMS error against fp64: output "
                  f"{e_out ** 0.5:.5e}, lse {e_lse ** 0.5:.4e}")

    for label, (s, kw) in cs.ATTN_SHAPES.items():
        q = torch.randn(s["B"], s["S"], s["H"], s["D"], generator=g, device="cuda").bfloat16()
        k = torch.randn(s["B"], s["T"], s["Hkv"], s["D"], generator=g, device="cuda").bfloat16()
        v = torch.randn(s["B"], s["T"], s["Hkv"], s["D"], generator=g, device="cuda").bfloat16()
        for name in fns:
            ms = cs.device_ms(torch, lambda: run(name, q, k, v, **kw), "flash_attention_fwd")
            readings[name][f"{label}: device ms"] = ms
            print(f"{name}, {label} bf16 on {card}: device {cs.fmt_ms(ms)} ms")

    if not args.no_route:
        from repro_torch.kernels.flash_attention import flash_attention_fwd
        from repro_torch.kernels.flash_decode import flash_decode
        from repro_torch.kernels.grouped_matmul import gmm
        from repro_torch.kernels.rmsnorm import rmsnorm
        from repro_torch.kernels.sampling import fused_sample

        counters = {"flash_attention_fwd": flash_attention_fwd, "rmsnorm": rmsnorm,
                    "flash_decode": flash_decode, "fused_sample": fused_sample, "gmm": gmm}
        for name in [n for n in fns if n != "parent"]:
            _build._loaded["flash_attention_fwd"] = ctypes.CDLL(str(libs[name]))
            print(f"---- the Scout generation phase with the {name} forward")
            try:
                cs.moe_phase(torch, counters, card)
                readings[name]["scout route check"] = "passed"
            except AssertionError as e:
                readings[name]["scout route check"] = f"failed: {e}"
            print(f"{name}: scout route check {readings[name]['scout route check']}")
            gc.collect()
            torch.cuda.empty_cache()
        _build._loaded["flash_attention_fwd"] = ctypes.CDLL(str(libs["tree"]))

    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "attention_variants.json").write_text(json.dumps({"card": card, "readings": readings},
                                                            indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
