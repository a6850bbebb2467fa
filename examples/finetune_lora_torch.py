"""LoRA fine-tuning with the PyTorch port: pre-train a small protein LM
briefly, freeze it, then adapt it with LoRA to a shifted distribution (a
different motif library) — the twin of ``examples/finetune_lora.py``.

    PYTHONPATH=src python examples/finetune_lora_torch.py [--device cpu]

The model runs on the GPU unless ``--device`` names another device.
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.core.config import ModelConfig, TrainConfig
from repro_torch.core.module import tree_leaves
from repro_torch.data.dataset import MemmapTokenDataset, synthetic_protein_sequences
from repro_torch.data.tokenizer import ProteinTokenizer
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.training import lora
from repro_torch.training.loop import run_training


def stream(ds, batch, seq, seed=0):
    rng = np.random.default_rng(seed)
    while True:
        idx = rng.integers(0, len(ds), size=batch)
        toks = np.zeros((batch, seq), np.int32)
        for r, i in enumerate(idx):
            s = ds[int(i)][:seq]
            toks[r, : len(s)] = s
        yield {"tokens": toks}


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="default: the GPU")
    a = p.parse_args()
    tok = ProteinTokenizer()
    cfg = ModelConfig(name="protein-lm", family="dense", num_layers=4, d_model=128,
                      num_heads=8, num_kv_heads=4, d_ff=512, vocab_size=tok.vocab_size,
                      dtype="float32")
    model = build_model(cfg, device=a.device)
    dev = model.device
    tmp = tempfile.TemporaryDirectory()

    # --- pre-train on motif library A ---
    seqs_a = synthetic_protein_sequences(800, seed=0)
    ds_a = MemmapTokenDataset.write(f"{tmp.name}/a", [np.asarray(tok.encode(s), np.int32)
                                                      for s in seqs_a])
    tc = TrainConfig(global_batch=8, seq_len=64, total_steps=80, learning_rate=3e-3,
                     warmup_steps=8, decay_steps=8, log_every=20)
    state, _ = run_training(model, tc, stream(ds_a, 8, 64))
    base = state.params

    # --- domain shift: motif library B ---
    seqs_b = synthetic_protein_sequences(800, seed=123)
    ds_b = MemmapTokenDataset.write(f"{tmp.name}/b", [np.asarray(tok.encode(s), np.int32)
                                                      for s in seqs_b])
    batches_b = ({k: torch.from_numpy(v).to(dev) for k, v in b.items()}
                 for b in stream(ds_b, 8, 64, seed=1))
    b0 = next(batches_b)
    with torch.no_grad():
        base_loss = model.loss_fn(base, b0)[0].item()

    # --- LoRA adaptation (base frozen, ~1% trainable) ---
    adapters = lora.init_adapters(base, rank=8, generator=torch.Generator(dev).manual_seed(7))
    n_base = sum(p.numel() for p in tree_leaves(base))
    n_lora = lora.count_trainable(adapters)
    print(f"\ntrainable: {n_lora:,} / {n_base:,} ({100 * n_lora / n_base:.2f}%)")
    loss_fn = lora.make_lora_loss(model, base)
    opt = adamw.init_state(adapters)
    tc_ft = TrainConfig(learning_rate=2e-3, weight_decay=0.0)
    lr = torch.tensor(2e-3, device=dev)
    leaves = tree_leaves(adapters)

    for i in range(60):
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = loss_fn(adapters, next(batches_b))
        grads = list(torch.autograd.grad(loss, leaves))
        opt = adamw.apply_updates(adapters, grads, opt, lr, tc_ft)
        if i % 20 == 0:
            print(f"ft step {i:3d} loss {loss.item():.4f}")

    with torch.no_grad():
        ft_loss = model.loss_fn(lora.merged_params(base, adapters), b0)[0].item()
    print(f"\ndomain-B loss: frozen base {base_loss:.4f} -> LoRA {ft_loss:.4f}")
    assert ft_loss < base_loss, "LoRA adaptation failed to improve"
    tmp.cleanup()


if __name__ == "__main__":
    main()
