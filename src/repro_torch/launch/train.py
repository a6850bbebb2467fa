"""End-to-end training launcher (the port's copy of the reference's
``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch esm2-650m \\
        --steps 200 --batch 8 --seq 1024 [--smoke] [--accum 4] \\
        [--sharded-data] [--max-tokens-per-batch 8192] [--producer 4] \\
        [--resume auto|<ckpt_dir>] [--device cpu]

    PYTHONPATH=src torchrun --nproc_per_node N -m repro_torch.launch.train \\
        --arch esm2-650m --mesh DxM ...

The model runs on the GPU unless ``--device`` names another device
(``--device cpu`` with ``--smoke``, the reduced config, is the practical
mode on a CPU).  ``--mesh`` (``launch/mesh.py::build_mesh``, shared with
the serving launcher): ``none`` trains on one device; ``auto`` takes a
(world, 1) mesh when torchrun started several ranks, else none; ``DxM`` a
(data, model) mesh, whose D·M must equal torchrun's ``WORLD_SIZE``.  The ranks meet over NCCL, each on
``cuda:LOCAL_RANK``, or over Gloo with ``--device cpu``; without torchrun
a ``1x1`` mesh is a world of one.  Size-aware batches then round their rows
to the data ranks, and only rank 0 prints and writes files.

The data plane: ``--sharded-data`` feeds from the multi-shard memmap store
(``data/store.py``) instead of the single-file dataset;
``--max-tokens-per-batch`` switches to size-aware (token-budget) batches,
variable rows padded per length bucket; ``--producer N`` builds the
batches on a background thread N batches ahead.

Telemetry: ``--metrics-dir DIR`` feeds the ``obs`` registry and rewrites
a Prometheus exposition and a JSON snapshot there at every log flush;
``--profile DIR`` writes a ``torch.profiler`` trace of the run into DIR
and prints the host-side step timer.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.config import ParallelConfig, TrainConfig
from repro_torch.data.dataset import build_synthetic_protein_memmap, build_synthetic_protein_store
from repro_torch.data.pipeline import CLMBatches, MLMBatches
from repro_torch.data.producer import BackgroundProducer
from repro_torch.data.sampler import ClusterSampler, greedy_length_clusters
from repro_torch.data.size_aware import SizeAwareSampler
from repro_torch.launch.mesh import build_mesh, rank_device
from repro_torch.models.model import build_model
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.profile import trace_ctx
from repro_torch.training.loop import Trainer


class Seq2SeqBatches:
    """CLM packing with a ``src_tokens`` mirror of ``tokens`` (an
    encoder-decoder's batches), the cursor delegated to the packing
    pipeline."""

    def __init__(self, base: CLMBatches):
        self.base = base

    def state_dict(self):
        return self.base.state_dict()

    def load_state_dict(self, st):
        self.base.load_state_dict(st)

    def __iter__(self):
        for b in self.base:
            b = dict(b)
            b["src_tokens"] = b["tokens"]
            yield b


def make_batches(cfg, tc: TrainConfig, data_dir: str, seed: int = 0, *,
                 sharded: bool = False, max_tokens: int = 0,
                 producer_depth: int = 0, round_to: int = 1):
    """The batch pipeline object (not an iterator), so that the Trainer can
    checkpoint and restore its cursor.

    ``sharded`` feeds from the sharded store instead of the single-file
    dataset; ``max_tokens`` > 0 switches to size-aware batches, each under
    that many padded tokens; ``producer_depth`` > 0 wraps the pipeline in a
    background producer; ``round_to`` rounds a size-aware batch's rows to
    a multiple of it (the data ranks).  An encoder-decoder takes
    ``Seq2SeqBatches`` of fixed shape (size-aware batching does not apply to
    it, as in the reference)."""
    if sharded:
        ds, tok = build_synthetic_protein_store(f"{data_dir}/protein_store", n=2000, seed=seed)
    else:
        ds, tok = build_synthetic_protein_memmap(f"{data_dir}/protein", n=2000, seed=seed)
    lengths = ds.lengths()
    base = ClusterSampler(greedy_length_clusters(lengths, 64), seed=seed)
    size_aware = (SizeAwareSampler(np.minimum(lengths, tc.seq_len), max_tokens, base=base,
                                   round_to=round_to)
                  if max_tokens else None)
    if cfg.objective == "mlm":
        pipe = MLMBatches(ds, tok, base if size_aware is None else size_aware,
                          tc.global_batch, tc.seq_len, cfg.mlm_mask_prob, seed)
    elif cfg.is_encoder_decoder:
        pipe = Seq2SeqBatches(CLMBatches(ds, tc.global_batch, tc.seq_len, seed,
                                         eos_id=tok.eos_id))
    else:
        pipe = CLMBatches(ds, tc.global_batch, tc.seq_len, seed, eos_id=tok.eos_id,
                          sampler=size_aware)
    if producer_depth:
        pipe = BackgroundProducer(pipe, depth=producer_depth)
    return pipe


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="esm2-650m")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--warmup", type=int, default=0, help="warmup steps (0 = steps//10)")
    p.add_argument("--accum", type=int, default=1,
                   help="gradient-accumulation microbatches per step")
    p.add_argument("--mesh", default="auto",
                   help="none | auto | DxM, e.g. 4x2 = (data=4, model=2); D*M = WORLD_SIZE")
    p.add_argument("--device", default=None,
                   help="device to train on (default: the GPU; 'cpu' runs on the CPU)")
    p.add_argument("--smoke", action="store_true", help="reduced config")
    p.add_argument("--data-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_data"))
    p.add_argument("--sharded-data", action="store_true",
                   help="feed from the multi-shard memmap store instead of the "
                        "single-file dataset")
    p.add_argument("--max-tokens-per-batch", type=int, default=0,
                   help="size-aware (token-budget) batching: variable-row batches padded "
                        "per length bucket, each under this many padded tokens "
                        "(0 = fixed --batch x --seq shapes)")
    p.add_argument("--producer", type=int, default=0,
                   help="background-producer prefetch depth (0 = build batches inline)")
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--ckpt-every", type=int, default=0,
                   help="checkpoint period in steps (0 = final-only when --ckpt-dir is set)")
    p.add_argument("--resume", default="",
                   help="checkpoint dir to resume from, or 'auto' = latest step_* under "
                        "--ckpt-dir")
    p.add_argument("--history-out", default="")
    p.add_argument("--metrics-dir", default="",
                   help="write a Prometheus exposition and JSON metric snapshots here "
                        "(refreshed at every log flush)")
    p.add_argument("--profile", default="",
                   help="write a torch.profiler trace of the run into this directory and "
                        "print the step timer")
    a = p.parse_args(argv)

    device = rank_device(a.device)
    started = not dist.is_initialized()
    mesh = build_mesh(a.mesh, device)
    try:
        _train(a, device, mesh)
    finally:
        if mesh is not None and started:
            dist.destroy_process_group()


def _train(a, device: torch.device, mesh) -> None:
    first = mesh is None or dist.get_rank() == 0
    say = print if first else (lambda *_, **__: None)
    cfg = get_smoke_config(a.arch) if a.smoke else get_config(a.arch)
    tc = TrainConfig(
        global_batch=a.batch, seq_len=a.seq, learning_rate=a.lr, accum_steps=a.accum,
        total_steps=a.steps, warmup_steps=a.warmup or max(a.steps // 10, 1),
        decay_steps=max(a.steps // 10, 1), ckpt_dir=a.ckpt_dir,
        ckpt_every=a.ckpt_every or (a.steps if a.ckpt_dir else 0),
    )
    say("resolved TrainConfig:")
    say(json.dumps(dataclasses.asdict(tc), indent=1))
    model = build_model(cfg, ParallelConfig(), mesh, device=device)
    layout = (f"mesh={model.ctx.sizes} {model.pc.attention_parallelism}" if mesh is not None
              else "mesh=None")
    say(f"arch={cfg.name} params(analytic)={cfg.param_count():,} {layout} device={device}")
    # every rank draws the same global batches from its own copy of the
    # synthetic data (written in parallel, so one directory a rank), and
    # size-aware batches keep their rows divisible by the data ranks
    data_dir = a.data_dir if mesh is None else os.path.join(a.data_dir, f"rank{dist.get_rank()}")
    batches = make_batches(cfg, tc, data_dir, sharded=a.sharded_data,
                           max_tokens=a.max_tokens_per_batch, producer_depth=a.producer,
                           round_to=model.ctx.data_ranks)
    resume = a.resume
    if resume == "auto":
        resume = ckpt.latest_step(a.ckpt_dir) or ""
        say(f"resume: {resume or '(no checkpoint found — cold start)'}")
    reg = MetricsRegistry() if a.metrics_dir and first else None
    hooks = []
    if reg is not None:
        os.makedirs(a.metrics_dir, exist_ok=True)

        def _dump(step, m, _reg=reg, _dir=a.metrics_dir):
            _reg.write_prometheus(os.path.join(_dir, "train.prom"))
            _reg.dump_json(os.path.join(_dir, "train_metrics.json"))

        hooks.append(_dump)
    trainer = Trainer(model, tc, hooks=hooks, metrics=reg, profile=bool(a.profile))
    try:
        with trace_ctx(a.profile if first else ""):
            _, history = trainer.run(batches, resume_from=resume or None)
    finally:
        if hasattr(batches, "close"):
            batches.close()
    if a.profile:
        say("step timer:")
        for line in trainer.step_timer.report().splitlines():
            say(f"  {line}")
    if a.history_out and first:
        with open(a.history_out, "w") as f:
            json.dump(history, f, indent=1)
    if history:
        say(f"final loss {history[-1]['loss']:.4f} (from {history[0]['loss']:.4f})  "
              f"{history[-1]['tokens_per_sec']:.0f} tok/s  "
              f"tokens_seen={history[-1]['tokens_seen']:.0f}")


if __name__ == "__main__":
    main()
