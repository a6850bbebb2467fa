"""Geneformer-style single-cell embedding with the PyTorch port: rank-value
encode synthetic expression profiles, train the reduced Geneformer recipe
briefly, extract cell embeddings through the serving engine (``LLM.embed``:
batched, length-bucketed, telemetry-instrumented), and check that they
cluster by cell "type" — the twin of ``examples/embed_cells.py``.

    PYTHONPATH=src python examples/embed_cells_torch.py [--device cpu] [--steps 60]

The model runs on the GPU unless ``--device`` names another device.
"""
import argparse
from typing import List, Optional

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.core.config import TrainConfig
from repro_torch.models.model import build_model
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serving.api import LLM
from repro_torch.training.loop import run_training

MASK_ID = 4          # <mask>; ids 0-4 are the special tokens


def rank_value_encode(expr: np.ndarray, top_k: int) -> np.ndarray:
    """Geneformer input encoding: genes sorted by expression, ids are gene
    indices (offset past special tokens)."""
    order = np.argsort(-expr, axis=1)[:, :top_k]
    return (order + 5).astype(np.int32)


def synthetic_cells(n: int, n_genes: int, n_types: int = 3, seed: int = 0):
    """``n`` Poisson expression profiles over ``n_genes`` genes, each drawn
    around one of ``n_types`` gamma-distributed centres -> (expr, types)."""
    rng = np.random.default_rng(seed)
    centers = rng.gamma(2.0, 1.0, size=(n_types, n_genes))
    types = rng.integers(0, n_types, size=n)
    expr = rng.poisson(centers[types] * 5).astype(np.float32)
    return expr, types


def main(argv: Optional[List[str]] = None) -> np.ndarray:
    """Runs the example; returns the (cells, d_model) fp32 embeddings."""
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="default: the GPU")
    p.add_argument("--steps", type=int, default=60)
    a = p.parse_args(argv)
    cfg = get_smoke_config("geneformer-106m")
    model = build_model(cfg, device=a.device)
    n_genes = cfg.vocab_size - 5
    S = 64
    print(f"arch={cfg.name} genes={n_genes} seq={S} device={model.device}")

    expr, types = synthetic_cells(512, n_genes)
    tokens = rank_value_encode(expr, S)

    rng = np.random.default_rng(0)

    def batches():
        while True:
            idx = rng.integers(0, len(tokens), size=16)
            t = tokens[idx]
            pick = rng.random(t.shape) < 0.15
            corrupted = t.copy()
            corrupted[pick] = MASK_ID
            yield {"tokens": corrupted, "targets": t, "loss_mask": pick.astype(np.float32)}

    warm = max(a.steps // 12, 1)
    tc = TrainConfig(global_batch=16, seq_len=S, total_steps=a.steps, learning_rate=3e-3,
                     warmup_steps=warm, decay_steps=warm, log_every=max(a.steps // 3, 1))
    run_training(model, tc, batches())       # trains the model's own weights in place

    # embed all cells through the serving engine: batched dispatch, masked
    # mean-pooling on the device, one bulk transfer of (n, d) vectors
    llm = LLM(model, slots=32, max_len=S, metrics=MetricsRegistry())
    embs = llm.embed([t.tolist() for t in tokens])
    c = llm.engine.counters
    print(f"embedded {embs.shape[0]} cells -> d={embs.shape[1]} "
          f"(engine: {c['submitted']} submitted, {c['completed']} completed)")

    # silhouette-ish check: same-type distance < cross-type distance
    same, cross = [], []
    for t in range(3):
        e, o = embs[types == t], embs[types != t]
        centre = e.mean(0)
        same.append(np.linalg.norm(e - centre, axis=1).mean())
        cross.append(np.linalg.norm(o - centre, axis=1).mean())
    print(f"mean same-type dist {np.mean(same):.3f} vs cross-type {np.mean(cross):.3f}")
    print("cell types separate:", bool(np.mean(cross) > np.mean(same)))
    return embs


if __name__ == "__main__":
    main()
