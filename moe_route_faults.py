#!/usr/bin/env python3
"""Plant faults in the grouped matmul's forward and print what the
Llama-4-Scout checks of ``chip_smoke.py`` read for each; or, with
``--spread``, measure those checks' statistics on sound kernels.

    python3 moe_route_faults.py [--spread] [--seeds 0 1 2 3 4]

Needs one card.  Both modes run ``chip_smoke.moe_route_check`` on the Scout
generation phase's model (full width, 8 of 48 layers, seeded random bf16
weights) and route prompts: the 8 that the phase picks from a seeded draw
of its load, prefilled at exact length into 8 of 32 slots, then 32 decode
steps teacher-forced with the kernel route's own tokens (the phase's
sampling parameters).  That check reads the share of router decisions
where the plain route's own router parts from the kernel route's, the
largest router margin among them (the near-tie statistic), the logits'
cosine, and ``moe_layer_check``: every MoE layer of the shortest and the
longest prompt's prefill against its plain twin, in bf16 steps.

``--spread``: the statistics on sound kernels, for each seed of
``--seeds`` (seed 0 is the phase's own draw) and each attention forward:
the tree's and the sound variants of ``attention_variants.py``, each swapped
in for the wrapper's library.  Their spread is what the check's bounds
are set from (``chip_smoke.MOE_NEAR_TIE``, ``MOE_LAYER_STEPS``).

Default: the faults.  Each is a set of textual edits of
``csrc/grouped_matmul.cu`` built into its own library under
``kernels/build/faults/`` (the source in the tree is not changed), swapped
in for the wrapper's library while the checks run on seed 0, after the
sound kernel.  Each fault is also read by the grouped matmul's own ragged
cases (rows within 2e-2 of each row's max against the plain version,
rows past the groups exactly 0).  An edit whose text is not in the source
raises.

Writes the readings to ``chiprun_out/moe_route_faults.json`` (faults) or
``chiprun_out/moe_route_spread.json`` (``--spread``).
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import gc
import json
import subprocess
import sys
import time

import chip_smoke as cs

# each fault: its edits of grouped_matmul.cu, (old text, new text), each old
# text found once; both of the forward's modes (the row-tile mode, kFwd, and
# the decode mode's split_item) are edited, the transposed mode is not
_ROWS_SLICE = ("    for (int s = 0; s < n_slices; ++s) {\n      mbar_wait(&full[stage], phase);\n"
               "      const uint32_t st = base + stage * kStageBytes;\n")
_SPLIT_SLICE = ("  for (int s = it.s0; s < it.s1; ++s) {\n    mbar_wait(&full[stage], phase);\n"
                "    const uint32_t st = base + stage * kStageBytes;\n")
FAULTS = {
    "group 1's last K slice dropped": [
        ("#pragma unroll\n          for (int kk = 0; kk < 4; ++kk) {\n            if constexpr (kFwd)",
         "          for (int kk = 0; kk < (kFwd && it.q == 1 && s == n_slices - 1 ? 0 : 4); ++kk) {\n"
         "            if constexpr (kFwd)"),
        ("#pragma unroll\n    for (int kk = 0; kk < 4; ++kk)\n#pragma unroll\n      for (int c = 0;",
         "    for (int kk = 0; kk < (it.g == 1 && s == p.n_slices - 1 ? 0 : 4); ++kk)\n"
         "#pragma unroll\n      for (int c = 0;")],
    "accumulators rounded to bf16 after each K slice": [
        (_ROWS_SLICE, _ROWS_SLICE +
         "      if (kFwd && s > 0) {\n        wgmma_wait<0>();\n        for (int j = 0; j < 2; ++j) {\n"
         "          reg_fence(acc[j]);\n          for (int v = 0; v < 64; ++v)\n"
         "            acc[j][v] = __bfloat162float(__float2bfloat16(acc[j][v]));\n        }\n      }\n"),
        (_SPLIT_SLICE, _SPLIT_SLICE +
         "    if (s > it.s0) {\n      wgmma_wait<0>();\n      for (int c = 0; c < kMaxRows / kChunk; ++c) {\n"
         "        reg_fence(acc[c]);\n        for (int v = 0; v < NR / 2; ++v)\n"
         "          acc[c][v] = __bfloat162float(__float2bfloat16(acc[c][v]));\n      }\n    }\n")],
    "group 1's rows times expert 2's weights": [
        ("tma_load(st + kABytes, mw, it.n0, 64 * s, it.q, &full[stage]);\n"
         "            tma_load(st + kABytes + kBox, mw, it.n0 + 64, 64 * s, it.q, &full[stage]);",
         "tma_load(st + kABytes, mw, it.n0, 64 * s, it.q == 1 ? 2 : it.q, &full[stage]);\n"
         "            tma_load(st + kABytes + kBox, mw, it.n0 + 64, 64 * s, it.q == 1 ? 2 : it.q, "
         "&full[stage]);"),
        ("tma_load(st, &mw, it.n0, 64 * s, it.g, &full[stage]);\n"
         "          tma_load(st + kBox, &mw, it.n0 + 64, 64 * s, it.g, &full[stage]);",
         "tma_load(st, &mw, it.n0, 64 * s, it.g == 1 ? 2 : it.g, &full[stage]);\n"
         "          tma_load(st + kBox, &mw, it.n0 + 64, 64 * s, it.g == 1 ? 2 : it.g, &full[stage]);")],
    "one row past each group's end written": [
        ("          if (r < it.hi)\n", "          if (r < it.hi + int(kFwd) && r < p.M)\n"),
        ("if (r < it.end && n < p.N) out[", "if (r <= it.end && r < p.M && n < p.N) out[")],
}


def build_faults():
    """One nvcc per fault, all started together -> {fault: library path}."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / "grouped_matmul.cu").read_text()
    out_dir = _build.BUILD_DIR / "faults"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, edits) in enumerate(FAULTS.items()):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"fault {name!r}: {old!r} is not in grouped_matmul.cu once")
            text = text.replace(old, new)
        cu = out_dir / f"grouped_matmul_fault{i}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        cmd = [_build.nvcc(), *_build.FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True))
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"fault {name!r} did not build:\n{log}")
    return {name: so for name, (so, _) in jobs.items()}


def kernel_cases(torch, np, ref, gmm):
    """The forward's ragged cases at Scout's widths (decode and prefill
    shapes, both modes): the worst row error against the plain version,
    and whether every row past the groups is exactly 0."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    w = (torch.randn(16, 5120, 8192, device=dev) * 5120 ** -0.5).bfloat16()
    err, tail0 = 0.0, True
    for M, sizes in ((32, cs._router_sizes(np, rng, 30, 16)),
                     (96, cs._router_sizes(np, rng, 90, 16)),
                     (1024, cs._router_sizes(np, rng, 1024, 16, cap=80))):
        x = torch.randn(M, 5120, device=dev).bfloat16()
        total = int(sizes.sum())
        x[total:] = 1e30
        gs = torch.as_tensor(sizes, dtype=torch.int32, device=dev)
        out = gmm(x, w, gs)
        want = ref.grouped_matmul_ref(x, w, gs)
        err = max(err, cs.row_rel_err(out[:total], want[:total]))
        tail0 &= bool((out[total:] == 0).all())
    del w
    return {"row_err": err, "tail_exactly_0": tail0, "caught": not (err <= 2e-2 and tail0)}


def route_inputs(torch, np, model, seed):
    """The phase's route prompts from the load drawn with ``seed``, and the
    (32, 32 slots) tokens that teacher-force them: the kernel route's own,
    with the phase's sampling parameters."""
    from repro_torch.serving.api import LLM

    lengths, prompts, params = cs.generation_load(np, model.cfg.vocab_size, 64, 32, seed)
    picks = [int(i) for i in np.argsort(lengths)[:: 64 // 8]]
    route_prompts = [prompts[i] for i in picks]
    outs = LLM(model, slots=32, max_len=2048).generate(route_prompts, [params[i] for i in picks])
    forced = torch.zeros((32, 32), dtype=torch.int32, device=model.device)
    for slot, c in enumerate(outs):
        forced[:, slot] = torch.tensor(c.tokens, dtype=torch.int32)
    return route_prompts, forced


def run_check(torch, np, model, route_prompts, forced):
    failed = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    reading = cs.moe_route_check(torch, np, model, dict(slots=32, max_len=2048), route_prompts,
                                 forced, expect)
    reading["failed"] = failed
    gc.collect()
    torch.cuda.empty_cache()
    return reading


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("moe_route_faults: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--spread", action="store_true")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    args = ap.parse_args()
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.models.model import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    t0 = time.perf_counter()
    names = ["flash_attention_fwd", "flash_decode", "sampling", "grouped_matmul", "rmsnorm"]
    jobs = _build.start_builds(names)
    if args.spread:
        import attention_variants

        libs = {"tree": None, **attention_variants.build("")}
    else:
        libs = {"sound": None, **build_faults()}
    _build.finish_builds(jobs)
    for name in names:
        _build.load(name)
    print(f"built the kernels and {len(libs) - 1} others in {time.perf_counter() - t0:.1f} s")

    results = {"card": card, "bounds": {"near_tie": cs.MOE_NEAR_TIE,
                                        "layer_steps": cs.MOE_LAYER_STEPS}}
    swapped = "flash_attention_fwd" if args.spread else "grouped_matmul"
    own = _build._loaded[swapped]
    if not args.spread:
        for name, so in libs.items():
            _build._loaded[swapped] = own if so is None else ctypes.CDLL(str(so))
            results[name] = {"kernel cases": kernel_cases(torch, np, ref, gm.gmm)}
            print(f"{name}: the forward's ragged cases {results[name]['kernel cases']}")
        _build._loaded[swapped] = own
        gc.collect()
        torch.cuda.empty_cache()

    cfg = dataclasses.replace(get_config("llama4-scout-17b-a16e"), num_layers=8,
                              param_dtype="bfloat16")
    model = build_model(cfg, seed=0)
    for seed in args.seeds if args.spread else [0]:
        route_prompts, forced = route_inputs(torch, np, model, seed)
        for name, so in libs.items():
            _build._loaded[swapped] = own if so is None else ctypes.CDLL(str(so))
            print(f"---- seed {seed}, {'attention forward' if args.spread else 'gmm forward'}: "
                  f"{name}")
            reading = run_check(torch, np, model, route_prompts, forced)
            _build._loaded[swapped] = own
            if args.spread:
                results[f"seed {seed}, {name}"] = reading
            else:
                layer = [f for f in reading["failed"] if f == cs.MOE_LAYER_FAULT]
                reading["caught"] = {"route check": len(reading["failed"]) > len(layer),
                                     "per-layer check": bool(layer),
                                     "kernel cases": results[name]["kernel cases"]["caught"]}
                results[name].update(reading)
            print(f"   {json.dumps(reading)}")
    if args.spread:
        runs = [v for k, v in results.items() if k.startswith("seed")]
        results["spread"] = {key: [min(r[key] if key != "layer_steps" else max(r[key]) for r in runs),
                                   max(r[key] if key != "layer_steps" else max(r[key]) for r in runs)]
                             for key in ("margin", "flips", "cos_min", "layer_steps")}
        print(f"spread over {len(runs)} runs on {card}: {json.dumps(results['spread'])}")
    out = cs.ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    name = "moe_route_spread.json" if args.spread else "moe_route_faults.json"
    (out / name).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
