#!/usr/bin/env python3
"""Plant faults in the SSD scan kernel and print what the Mamba2 checks of
``chip_smoke.py`` read for each: the route check (``anchored_compare``:
the kernel route against an fp32-compute route, beside the plain route)
and the per-layer check (``ssm_layer_check``: every SSD layer within 2
bf16 steps of its plain twin).

    python3 ssd_route_faults.py

Needs one card.  Each fault is a textual edit of ``csrc/ssd_scan.cu``
built into its own library under ``kernels/build/faults/`` (the source in
the tree is not changed): a product's low bf16 half dropped from att x or
from the state update, y's carried-state term decayed one row short, or
D x dropped; the wrapper's library is swapped for it while
the checks run.  The route check is the Mamba2 phase's: Mamba2-2.7B at
full width and depth with seeded random bf16 weights, the phase's prompts
(the 8 it picks, exact-length prefill into 8 of 32 slots), then 32 decode
steps teacher-forced with the sound kernel route's greedy tokens.  Also
prints the spread of two sound plain routes (the scan at chunks of 64 and
of 128).  Writes the readings to ``chiprun_out/ssd_route_faults.json``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import subprocess
import sys
import time

import chip_smoke as cs

FAULTS = {
    "att's low half dropped (att rounded to bf16)": (
        """          Mma<T>::run(y[2 * jp], al, bx[0], bx[1]);
          Mma<T>::run(y[2 * jp + 1], al, bx[2], bx[3]);
""", ""),
    "the state-update operand's low half dropped (bf16 update weights)": (
        """          Mma<T>::run(hs[2 * jn], al, bb[0], bb[1]);
          Mma<T>::run(hs[2 * jn + 1], al, bb[2], bb[3]);
""", ""),
    "carried state decayed one row short": (
        "const float ea = ex2(ca_), eb = ex2(cb_);",
        "const float ea = ex2(ca_ - dts[ta] * a2), eb = ex2(cb_ - dts[tb] * a2);"),
    "D x dropped": (
        "Mma<T>::pack(y[j][2 * r] + xv.x * dsc, y[j][2 * r + 1] + xv.y * dsc);",
        "Mma<T>::pack(y[j][2 * r], y[j][2 * r + 1]);"),
}


def build_faults():
    """One nvcc per fault, all started together -> {fault: library path}."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / "ssd_scan.cu").read_text()
    out_dir = _build.BUILD_DIR / "faults"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, (old, new)) in enumerate(FAULTS.items()):
        if src.count(old) != 1:
            raise RuntimeError(f"fault {name!r}: the edited line is not in ssd_scan.cu once")
        cu = out_dir / f"ssd_scan_fault{i}.cu"
        cu.write_text(src.replace(old, new))
        so = cu.with_suffix(".so")
        cmd = [_build.nvcc(), *_build.FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True))
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"fault {name!r} did not build:\n{log}")
    return {name: so for name, (so, _) in jobs.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ssd_route_faults: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models.model import Model, build_model
    from repro_torch.serving.api import LLM
    from repro_torch.serving.sampling import SamplingParams

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    t0 = time.perf_counter()
    libs = build_faults()
    sound, own_lib = ss._lib(), ss._lib
    print(f"built the sound kernel and {len(libs)} faulty ones in {time.perf_counter() - t0:.1f} s")

    # the Mamba2 phase's model, prompts and route picks
    cfg = dataclasses.replace(get_config("mamba2-2.7b"), param_dtype="bfloat16")
    model = build_model(cfg, seed=0)
    slots, max_len, n, n_forced = 32, 2048, 64, 32
    rng = np.random.default_rng(0)
    lengths = rng.integers(64, 1025, size=n)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(L)).tolist() for L in lengths]
    picks = [int(i) for i in np.argsort(lengths)[:: n // 8]]
    route_prompts = [prompts[i] for i in picks]
    outs = LLM(model, slots=slots, max_len=max_len).generate(
        route_prompts, [SamplingParams(max_new=n_forced)] * len(picks))
    forced = torch.tensor([c.tokens for c in outs], dtype=torch.int32, device=model.device).T
    forced = torch.nn.functional.pad(forced, (0, slots - len(picks))).contiguous()
    route = dict(slots=slots, max_len=max_len)
    label = cs.route_label(lengths, picks, n_forced)

    logits = {}
    for name, over in (("plain", dict(kernel_impl="torch")),
                       ("plain, chunk 64", dict(kernel_impl="torch", ssm_chunk=64)),
                       ("fp32", dict(kernel_impl="torch", dtype="float32"))):
        other = Model(dataclasses.replace(cfg, **over), model.params.tree())
        logits[name] = cs.engine_logits(torch, np, other, route, route_prompts, forced)[0]
        del other
    spread = torch.nn.functional.cosine_similarity(logits["plain, chunk 64"], logits["plain"],
                                                   dim=-1)
    print(f"{label}: the plain route at chunks of 64 vs 128: cosine min "
          f"{spread.min().item():.6f} (first tokens {spread[0].min().item():.6f})")
    plain_cfg = dataclasses.replace(cfg, kernel_impl="torch")
    results = {"card": card, "plain_chunk64_vs_128_min": spread.min().item()}
    for name, lib in [("sound", sound), *libs.items()]:
        if lib is not sound:
            lib = ctypes.CDLL(str(lib))
            lib.ssd_scan.argtypes = sound.ssd_scan.argtypes
            lib.ssd_scan.restype = sound.ssd_scan.restype
        ss._lib = lambda lib=lib: lib
        failed = []

        def expect(ok: bool, what: str) -> None:
            if not ok:
                failed.append(what)

        logits["kernel"] = cs.engine_logits(torch, np, model, route, route_prompts, forced)[0]
        print(f"-- kernel: {name}")
        reading = cs.anchored_compare(torch, logits, label, expect)
        route_failed = list(failed)
        steps, state = cs.ssm_layer_check(torch, model, plain_cfg, route_prompts[-1], expect)
        caught = {"route check": bool(route_failed),
                  "per-layer check": len(failed) > len(route_failed)}
        print(f"   caught by: {caught}")
        results[name] = dict(reading, layer_bf16_steps=steps, layer_state_err=state, caught=caught)
    ss._lib = own_lib
    (cs.ROOT / "chiprun_out").mkdir(exist_ok=True)
    (cs.ROOT / "chiprun_out" / "ssd_route_faults.json").write_text(json.dumps(results, indent=1))
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
