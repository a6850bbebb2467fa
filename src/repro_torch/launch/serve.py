"""Serving launcher (the port's copy of the reference's ``launch/serve.py``).

Continuous batching (decoder-only archs) drives the serving engine
through ``serving/api.py::LLM``: ``--cache-layout paged`` serves from the
paged KV cache, ``--prefix-cache`` / ``--prefill-chunk N`` add
content-addressed prefix sharing and bounded chunked prefill, and
``--temperature/--top-k/--top-p/--seed`` set the per-request sampling
params (greedy by default; fused on-device sampling either way):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b --smoke \
        --continuous --cache-layout paged --page-size 16 --requests 16 \
        --prefix-cache --prefill-chunk 32 --temperature 0.8 --top-k 40

It runs on the GPU unless ``--device cpu`` asks for the CPU.  ``--mesh``
(``launch/mesh.py::build_mesh``, as the training launcher's): ``auto``
(the default) serves on one device, or on (world, 1) replicas when torchrun
started several ranks; ``DxM`` serves tensor-parallel on a (data, model)
mesh of D·M = ``WORLD_SIZE`` ranks, the heads split over ``model``
(head-TP; ``serving/engine.py``, "Sharded serving") and the data ranks
replicas, over NCCL with a rank a GPU (Gloo with ``--device cpu``):

    PYTHONPATH=src torchrun --nproc_per_node 8 -m repro_torch.launch.serve \
        --arch qwen2-7b --continuous --mesh 2x4 --cache-layout paged --prefix-cache

Every rank serves the same requests; only rank 0 prints and writes the
metrics, the trace and the profile.

Telemetry (``repro_torch.obs``): ``--health-every N`` prints the engine's
health snapshot every N steps while serving (default 64: a wedged engine
shows as the watchdog climbs, not only at exit); ``--metrics-dir DIR``
refreshes a Prometheus exposition and a JSON snapshot there on the same
cadence; ``--trace PATH`` writes the request-lifecycle JSONL at exit;
``--profile DIR`` captures a ``torch.profiler`` trace of the run
(``obs/profile.py::trace_ctx``) and prints the engine's step timer.

The static batch (``generate``) stays for the batches the engine does not
admit:

    model = build_model(get_config("molmim-65m"))          # on the GPU
    toks, tok_s = generate(model, None, {"tokens": prompts, "src_tokens": sources},
                           max_len=128, steps=64)

an encoder-decoder whose encoder length is its source's (MolMIM), or a
batch in which every row has its own audio or image (``enc_embeds`` or
``img_embeds`` of B rows, where the engine holds one for all requests).
One ``Model.prefill`` of the whole batch, then one ``Model.decode_step`` a
token, each token picked on the device by ``ops.sample_tokens`` (the fused
sampler kernel on the card) with the reference's per-row seeds
``arange(B) + seed`` and generation index ``i``, so a sampled run draws the
reference's tokens.  It runs where the model is.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.config import ParallelConfig, ServeConfig
from repro_torch.kernels import ops
from repro_torch.launch.mesh import build_mesh, rank_device
from repro_torch.models.model import Model, build_model


@torch.no_grad()
def generate(model, params: Optional[Dict[str, Any]], batch: Dict[str, Any], *, max_len: int,
             steps: int, temperature: float = 0.0, seed: int = 0, top_k: int = 0,
             top_p: float = 1.0) -> Tuple[torch.Tensor, float]:
    """Static-batch generation loop -> (tokens (B, steps) int32 on the
    model's device, generated tokens/s).

    ``params`` is the model's tree (None: its serving view,
    ``Model.serving_params``); ``batch`` holds
    ``tokens`` (B, S) and what the model's prefill takes beside them
    (``src_tokens``, ``enc_embeds``, ``img_embeds``), numpy or tensors,
    moved to the model's device.  Step ``i`` picks row b's token with
    seed ``b + seed`` (mod 2^32) at generation index ``i``; greedy when
    ``temperature`` <= 0.  The cache holds ``max_len`` rows."""
    params = model.serving_params() if params is None else params
    dev = model.device
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    B = batch["tokens"].shape[0]
    impl = model.cfg.kernel_impl
    seeds = (np.arange(B, dtype=np.uint32) + np.uint32(seed & 0xFFFFFFFF)).view(np.int32)
    samp = (torch.full((B,), temperature, dtype=torch.float32, device=dev),
            torch.full((B,), top_k, dtype=torch.int32, device=dev),
            torch.full((B,), top_p, dtype=torch.float32, device=dev),
            torch.as_tensor(seeds, device=dev))
    logits, cache = model.prefill(params, batch, max_len)
    outs = []
    t0 = time.perf_counter()
    for i in range(steps):
        gen = torch.full((B,), i, dtype=torch.int32, device=dev)
        tok, _ = ops.sample_tokens(logits[:, -1], *samp, gen, impl=impl)
        outs.append(tok)
        logits, cache = model.decode_step(params, cache, tok[:, None])
    toks = torch.stack(outs, dim=1)
    if toks.is_cuda:
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    return toks, toks.numel() / dt


def _health_line(h) -> str:
    return (
        f"steps={h.steps} queue={h.queue_depth} "
        f"active={h.active_slots}/{h.slots} "
        f"free_pages={h.free_pages}/{h.total_pages} "
        f"stalled_steps={h.steps_since_progress} counters={h.counters}"
    )


def serve_continuous(model, params: Optional[Dict[str, Any]], sc: ServeConfig, *, gen: int,
                     prompt_len: int, requests: int, health_every: int = 0,
                     metrics_dir: str = "", trace_path: str = "", profile: bool = False) -> None:
    """Drive the continuous-batching engine through the LLM facade over the
    reference's load: ``requests`` prompts of ``prompt_len // 2`` to
    ``prompt_len`` ids in ``[5, vocab)`` from ``default_rng(0)``, each even
    one behind a shared preamble of ``max(page_size, prompt_len // 2)`` ids
    when the prefix cache is on; request i samples with seed
    ``sc.seed + i``.  ``params`` is the model's tree, or None for its own.

    Telemetry: ``health_every=N`` prints the health snapshot every N
    engine steps while serving and, with ``metrics_dir``, refreshes the
    Prometheus exposition and JSON snapshot there on the same cadence.
    ``trace_path`` writes the lifecycle JSONL at exit; ``profile`` turns
    on the engine's profiler scopes and step timer, whose report it
    prints.  On a mesh every rank serves the load and only the mesh's
    first rank prints and writes."""
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.trace import TraceRecorder
    from repro_torch.serving.api import LLM
    from repro_torch.serving.sampling import SamplingParams

    if params is not None:
        model = Model(model.cfg, params, model.pc)
    first = model.ctx.is_first
    say = print if first else (lambda *_, **__: None)
    health_every = health_every if first else 0
    reg = MetricsRegistry() if first and (metrics_dir or health_every) else None
    tracer = TraceRecorder(capacity=16384) if trace_path and first else None

    def _dump_metrics() -> None:
        if reg is not None and metrics_dir:
            os.makedirs(metrics_dir, exist_ok=True)
            reg.write_prometheus(os.path.join(metrics_dir, "serve.prom"))
            reg.dump_json(os.path.join(metrics_dir, "serve_metrics.json"))

    def _on_step(eng) -> None:
        # periodic liveness output: a stall shows while the watchdog
        # climbs, not only in the exit summary
        if health_every and eng.steps % health_every == 0:
            print(f"  [step {eng.steps}] {_health_line(eng.health())}")
            _dump_metrics()

    cfg = model.cfg
    rng = np.random.default_rng(0)
    llm = LLM.from_config(model, sc, metrics=reg, trace=tracer, profile=profile,
                          on_step=_on_step if health_every else None)
    # a shared task preamble on half the requests exercises the prefix
    # cache (fixed scaffolds); at least one full page long, else no block
    # can ever hash-hit
    preamble = rng.integers(5, cfg.vocab_size, size=max(sc.page_size, prompt_len // 2)
                            ).astype(np.int32)
    prompts: List[np.ndarray] = []
    plist: List[SamplingParams] = []
    for i in range(requests):
        n = int(rng.integers(max(1, prompt_len // 2), prompt_len + 1))
        prompt = rng.integers(5, cfg.vocab_size, size=n).astype(np.int32)
        if sc.prefix_cache and i % 2 == 0:
            prompt = np.concatenate([preamble, prompt])[: sc.max_seq_len - gen - 1]
        prompts.append(prompt)
        plist.append(SamplingParams(
            temperature=sc.temperature, top_k=sc.top_k, top_p=sc.top_p,
            seed=sc.seed + i, max_new=gen, deadline_ms=sc.deadline_ms,
        ))
    t0 = time.time()
    outs = llm.generate(prompts, plist)
    wall = time.time() - t0
    eng = llm.engine
    served = [c for c in outs if c.finish_reason in ("stop", "length")]
    degraded = [c for c in outs if c.finish_reason not in ("stop", "length")]
    toks = sum(len(c.tokens) for c in outs)
    ttft = float(np.mean([c.ttft_s for c in served])) * 1e3 if served else 0.0
    itl = float(np.mean([
        (c.latency_s - c.ttft_s) / max(len(c.tokens) - 1, 1) for c in served
    ])) * 1e3 if served else 0.0
    extra = ""
    if eng.alloc is not None and sc.prefix_cache:
        st = eng.alloc.stats
        extra = (
            f", prefix-cache: {st['hit_tokens']} tokens reused, "
            f"{st['evictions']} evictions, {st['cow_copies']} COW copies"
        )
    say(
        f"[{sc.cache_layout}] served {len(served)}/{len(outs)} requests / "
        f"{toks} tokens on {eng.slots} slots: {toks / wall:.1f} tok/s, "
        f"ttft {ttft:.1f}ms, itl {itl:.2f}ms{extra}"
    )
    if degraded:
        by_reason: Dict[str, int] = {}
        for c in degraded:
            by_reason[c.finish_reason] = by_reason.get(c.finish_reason, 0) + 1
        say("  degraded outcomes: "
              + ", ".join(f"{k}={v}" for k, v in sorted(by_reason.items())))
    say(f"  health: {_health_line(eng.health())}")
    _dump_metrics()
    if tracer is not None:
        tracer.write(trace_path)
        print(f"  trace: {len(tracer)} lifecycle events -> {trace_path}"
              + (f" ({tracer.dropped} older events dropped)" if tracer.dropped else ""))
    if profile and first and eng.step_timer is not None and eng.step_timer.totals:
        print("  step timer:")
        for line in eng.step_timer.report().splitlines():
            print(f"    {line}")


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="molmim-65m")
    p.add_argument("--smoke", action="store_true", help="reduced config")
    p.add_argument("--device", default=None,
                   help="device to serve on (default: the GPU; 'cpu' runs on the CPU)")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--gen", type=int, default=16)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=0,
                   help="per-request top-k filter (0 = disabled)")
    p.add_argument("--top-p", type=float, default=1.0,
                   help="per-request nucleus filter (1.0 = disabled)")
    p.add_argument("--seed", type=int, default=0,
                   help="sampling seed (request i uses seed+i)")
    p.add_argument("--continuous", action="store_true",
                   help="continuous-batching engine instead of a static batch")
    p.add_argument("--mesh", default="auto",
                   help="none | auto | DxM, e.g. 2x4 = (data=2, model=4): head-TP over model, "
                        "replicas over data; D*M = WORLD_SIZE (torchrun)")
    p.add_argument("--cache-layout", choices=("dense", "paged"), default="dense")
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--prefix-cache", action="store_true",
                   help="content-addressed prefix sharing (paged layout)")
    p.add_argument("--prefill-chunk", type=int, default=0,
                   help="bound prefill to N-token chunks interleaved with decode steps "
                        "(paged layout; 0 = one chunk)")
    p.add_argument("--max-queue", type=int, default=0,
                   help="bounded admission queue; overflow submits are rejected with a "
                        "typed retriable error (0 = unbounded)")
    p.add_argument("--preempt", action="store_true",
                   help="under page pressure, preempt and requeue the newest in-flight "
                        "decode instead of blocking the queue head (paged layout; resumed "
                        "output is token-identical)")
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="default per-request deadline from submit; expired requests finish "
                        "with finish_reason='timeout'")
    p.add_argument("--health-every", type=int, default=64,
                   help="print Engine.health() (and refresh --metrics-dir) every N engine "
                        "steps while serving (0 = exit-only)")
    p.add_argument("--metrics-dir", default="",
                   help="write Prometheus exposition + JSON metric snapshots here "
                        "(refreshed on the --health-every cadence)")
    p.add_argument("--trace", default="", dest="trace_path",
                   help="write the request-lifecycle JSONL trace to this path at exit")
    p.add_argument("--profile", default="",
                   help="write a torch.profiler trace of the serving run into this "
                        "directory (also turns on the engine's step timer)")
    a = p.parse_args(argv)

    device = rank_device(a.device)
    started = not dist.is_initialized()
    try:
        mesh = build_mesh(a.mesh, device)
    except ValueError as e:
        raise SystemExit(str(e))
    try:
        _serve(a, device, mesh)
    finally:
        if mesh is not None and started:
            dist.destroy_process_group()


def _serve(a, device: torch.device, mesh) -> None:
    cfg = get_smoke_config(a.arch) if a.smoke else get_config(a.arch)
    model = build_model(cfg, ParallelConfig(), mesh, device=device, seed=0)
    if a.continuous:
        max_prompt = a.prompt_len * (2 if a.prefix_cache else 1)
        sc = ServeConfig(
            max_seq_len=max_prompt + a.gen + cfg.num_frontend_tokens + 1,
            batch_size=a.batch, temperature=a.temperature,
            top_k=a.top_k, top_p=a.top_p, seed=a.seed,
            cache_layout=a.cache_layout, page_size=a.page_size,
            prefix_cache=a.prefix_cache, prefill_chunk=a.prefill_chunk,
            max_queue=a.max_queue, preempt=a.preempt,
            deadline_ms=a.deadline_ms,
        )
        from repro_torch.obs.profile import trace_ctx

        with trace_ctx(a.profile if model.ctx.is_first else ""):
            serve_continuous(model, None, sc, gen=a.gen, prompt_len=a.prompt_len,
                             requests=a.requests, health_every=a.health_every,
                             metrics_dir=a.metrics_dir, trace_path=a.trace_path,
                             profile=bool(a.profile))
        return
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(5, cfg.vocab_size, size=(a.batch, a.prompt_len))
             .astype(np.int32)}
    if cfg.is_encoder_decoder:
        if cfg.frontend == "audio_stub":
            batch["enc_embeds"] = rng.normal(
                size=(a.batch, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32)
        else:
            batch["src_tokens"] = batch["tokens"]
    if cfg.frontend == "vision_stub":
        batch["img_embeds"] = rng.normal(
            size=(a.batch, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32)
    toks, tps = generate(model, None, batch,
                         max_len=a.prompt_len + a.gen + cfg.num_frontend_tokens + 1,
                         steps=a.gen, temperature=a.temperature, seed=a.seed,
                         top_k=a.top_k, top_p=a.top_p)
    if model.ctx.is_first:
        print(f"generated {tuple(toks.shape)} tokens at {tps:.1f} tok/s")
        print(toks[:, :12].cpu().numpy())


if __name__ == "__main__":
    main()
