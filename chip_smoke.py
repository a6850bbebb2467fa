#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's kernels from the sources in this checkout and holds each
kernel against its plain PyTorch version on the card.  Then drives the two
paths ported so far at the full width and depth of ESM-2 650M (seeded
random weights): embedding serving through ``LLM.embed``, and MLM
pre-training through ``Trainer.run`` (about 10 optimizer steps), and checks
what comes out of each.  Prints per-kernel times beside their bounds, the
embedding throughput, the training step time, tokens/s, MFU and peak memory,
a profile of each path, then one JSON line of kernel records and, last,
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result, when
there is no CUDA device or a phase fails.  Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12          # outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
AMINO_ACIDS = "ACDEFGHIKLMNPQRSTVWY"


def time_ms(torch, fn, trials: int = 20, per_trial: int = 10, warmup: int = 3) -> float:
    """Median over ``trials`` of the mean time of ``per_trial`` back-to-back
    calls of ``fn``, timed with CUDA events.  Back-to-back calls keep the
    host's launch latency off the device's clock."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per_trial):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_trial)
    return statistics.median(times)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    """(least time in ms, what bounds it) for work of ``flops`` operations
    moving ``nbytes`` bytes."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def rel_err(got, want) -> float:
    """max |got - want| over max |want|, in fp32."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-30)).item()


def kernel_groups(prof, DeviceType):
    """Device time by group from a torch.profiler run: (busy ms, {group: ms},
    [(name, ms, count)]).  CPU ops report their kernels' time too, so only
    device-side entries count; "Command Buffer Full" marks the host waiting
    on a full launch queue."""
    kern = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and "Command Buffer Full" not in e.key]
    groups = {"flash_attention_fwd": 0.0, "flash_attention_bwd": 0.0, "cross_entropy": 0.0,
              "layernorm": 0.0, "matmul": 0.0, "other": 0.0}
    for name, t, _ in kern:
        low = name.lower()
        if "flash_attention_fwd" in low:
            groups["flash_attention_fwd"] += t
        elif any(w in low for w in ("dq_kernel", "dkv_kernel", "delta_kernel")):
            groups["flash_attention_bwd"] += t
        elif any(w in low for w in ("ce_fwd_kernel", "ce_dh_kernel", "ce_dw_kernel", "ce_dw_sum_kernel")):
            groups["cross_entropy"] += t
        elif "layernorm" in low:
            groups["layernorm"] += t
        elif any(w in low for w in ("gemm", "xmma", "cutlass", "nvjet")):
            groups["matmul"] += t
        else:
            groups["other"] += t
    return sum(t for _, t, _ in kern), groups, kern


def leaf_paths(tree, prefix=""):
    """Paths of a nested dict's leaves in sorted-key order (``tree_leaves``'s)."""
    return [n for k in sorted(tree) for n in (
        leaf_paths(tree[k], f"{prefix}{k}/") if isinstance(tree[k], dict) else [prefix + k])]


def check_attention_bwd(torch, F, ref, flash_attention_fwd, flash_attention_bwd, randn, card):
    """Row 2 against ``attention_bwd_ref``; times it at the ESM-2 training
    shape.  Returns its kernel record (launches filled in later)."""
    # tolerance relative to max|ref| per gradient: the kernel rounds P and
    # dS to the input dtype before the three products that take them (at
    # most 2^-9 relative per element in bf16, 2^-12 in fp16) where the
    # plain version keeps fp32; the gradients are rounded once in both
    tol = {torch.bfloat16: 2e-2, torch.float16: 4e-3}
    cases = [
        ("esm2-650m training shape", dict(B=8, S=1024, T=1024, H=20, Hkv=20, D=64), dict(causal=False)),
        ("causal", dict(B=2, S=128, T=128, H=4, Hkv=4, D=64), dict(causal=True)),
        ("causal window", dict(B=2, S=200, T=200, H=4, Hkv=4, D=64), dict(causal=True, window=48)),
        ("softcap", dict(B=2, S=96, T=96, H=4, Hkv=4, D=64), dict(causal=False, softcap=20.0)),
        ("gqa H=8 Hkv=2", dict(B=2, S=128, T=128, H=8, Hkv=2, D=64), dict(causal=True)),
        ("D=128", dict(B=2, S=128, T=128, H=4, Hkv=4, D=128), dict(causal=False)),
        ("non-multiple S/T", dict(B=3, S=77, T=131, H=4, Hkv=4, D=64), dict(causal=False)),
        ("q_offset", dict(B=2, S=40, T=104, H=4, Hkv=2, D=128), dict(causal=True, q_offset=64)),
        ("fully-masked rows", dict(B=1, S=24, T=24, H=2, Hkv=2, D=64), dict(causal=True, q_offset=-8)),
    ]
    first_err = 0.0
    for label, s, kw in cases:
        for dt in (torch.bfloat16, torch.float16):
            q = randn(s["B"], s["S"], s["H"], s["D"], dtype=dt)
            k = randn(s["B"], s["T"], s["Hkv"], s["D"], dtype=dt)
            v = randn(s["B"], s["T"], s["Hkv"], s["D"], dtype=dt)
            do = randn(s["B"], s["S"], s["H"], s["D"], dtype=dt)
            out, lse = flash_attention_fwd(q, k, v, **kw)
            got = flash_attention_bwd(q, k, v, out, lse, do, **kw)
            torch.cuda.synchronize()
            want = ref.attention_bwd_ref(q, k, v, out, lse, do, **kw)
            errs = [rel_err(g, w) for g, w in zip(got, want)]
            finite = all(bool(g.isfinite().all()) for g in got)
            print(f"flash_attention_bwd {label} {str(dt)[6:]}: rel err dq {errs[0]:.3g} "
                  f"dk {errs[1]:.3g} dv {errs[2]:.3g} (tol {tol[dt]} of max|ref|)")
            check(finite and max(errs) <= tol[dt], f"flash_attention_bwd {label} {dt}")
            if label.startswith("fully-masked"):
                check(bool((got[0][:, :8] == 0).all()), "fully-masked rows: dq is not zero")
            if label.startswith("esm2") and dt == torch.bfloat16:
                first_err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))

    B, S, H, D = 8, 1024, 20, 64
    q, k, v, do = (randn(B, S, H, D) for _ in range(4))
    out, lse = flash_attention_fwd(q, k, v, causal=False)
    ms = time_ms(torch, lambda: flash_attention_bwd(q, k, v, out, lse, do, causal=False))
    plain_ms = time_ms(torch, lambda: ref.attention_bwd_ref(q, k, v, out, lse, do, causal=False),
                       trials=5, per_trial=2)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt)
    dot = do.transpose(1, 2).contiguous()
    lib_ms = time_ms(torch, lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True))
    # 5 products of 2*B*H*S*T*D each (QK^T and dO V^T in both passes, dQ,
    # dK, dV); bytes: q, k, v, out, dO, lse read, dq, dk, dv written
    bound_ms, bound_by = bound(10 * B * H * S * S * D, 8 * B * S * H * D * 2 + B * H * S * 4)
    print(f"flash_attention_bwd B={B} S=T={S} H={H} D={D} bf16 on {card}: {ms:.4f} ms "
          f"(bound {bound_ms:.4f} ms by {bound_by}, {10 * B * H * S * S * D / ms / 1e9:.1f} TFLOP/s), "
          f"plain {plain_ms:.4f} ms, scaled_dot_product_attention backward {lib_ms:.4f} ms")
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention.py:451",
            "launches": 0, "max_abs_err": first_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}


def check_cross_entropy(torch, F, ref, cross_entropy_fwd, cross_entropy_bwd, randn, g, card):
    """Rows 3 and 4 against their plain versions; times them at the ESM-2
    training shape.  Returns their kernel records."""
    dev = torch.device("cuda")
    # loss/lse: fp32 logits of the same products summed in another order;
    # dh/dw: the kernel rounds dlogits to bf16 before the two products
    # (2^-9 relative per element) where the plain version keeps fp32
    loss_tol, grad_tol = 2e-4, 2e-2
    cases = [
        ("esm2-650m tied head", dict(T=8192, D=1280, Vp=256, vocab=33, tied=True)),
        ("ragged T, untied head", dict(T=1000, D=1280, Vp=256, vocab=33, tied=False)),
        ("Vpad 32768, 512 vocab tiles", dict(T=2048, D=1280, Vp=32768, vocab=32000, tied=True)),
    ]
    errs0 = {}
    for label, c in cases:
        T, D, Vp, vocab = c["T"], c["D"], c["Vp"], c["vocab"]
        h = randn(T, D)
        w = randn(Vp, D, scale=0.05).T if c["tied"] else randn(D, Vp, scale=0.05)
        tgt = torch.randint(0, vocab, (T,), device=dev, generator=g, dtype=torch.int32)
        gl = torch.rand(T, device=dev, generator=g) / T
        gs = torch.rand(T, device=dev, generator=g) * (0.1 / T)     # a nonzero lse cotangent
        loss, lse = cross_entropy_fwd(h, w, tgt, vocab=vocab)
        dh, dw = cross_entropy_bwd(h, w, tgt, lse, gl, gs, vocab=vocab)
        torch.cuda.synchronize()
        r_loss, r_lse = ref.cross_entropy_ref(h, w, tgt, vocab)
        r_dh, r_dw = ref.cross_entropy_bwd_ref(h, w, tgt, r_lse, gl, gs, vocab)
        e_loss = max((loss - r_loss).abs().max().item(), (lse - r_lse).abs().max().item())
        e_dh, e_dw = rel_err(dh, r_dh), rel_err(dw, r_dw)
        pad_zero = bool((dw[:, vocab:] == 0).all())
        print(f"cross_entropy {label} (T={T}, D={D}, Vpad={Vp}, vocab={vocab}): loss/lse err "
              f"{e_loss:.3g} (tol {loss_tol}), dh {e_dh:.3g}, dw {e_dw:.3g} (tol {grad_tol} of "
              f"max|ref|), padded dw columns exactly 0: {pad_zero}")
        check(e_loss <= loss_tol and bool(loss.isfinite().all()), f"cross_entropy_fwd {label}")
        check(e_dh <= grad_tol and e_dw <= grad_tol and pad_zero, f"cross_entropy_bwd {label}")
        if not errs0:
            errs0 = {"fwd": e_loss, "bwd": max((dh.float() - r_dh.float()).abs().max().item(),
                                               (dw.float() - r_dw.float()).abs().max().item())}

    T, D, Vp, vocab = 8192, 1280, 256, 33
    h = randn(T, D)
    w = randn(Vp, D, scale=0.05).T
    tgt = torch.randint(0, vocab, (T,), device=dev, generator=g, dtype=torch.int32)
    gl = torch.full((T,), 1.0 / T, device=dev)
    gs = torch.zeros(T, device=dev)
    loss, lse = cross_entropy_fwd(h, w, tgt, vocab=vocab)
    fwd_ms = time_ms(torch, lambda: cross_entropy_fwd(h, w, tgt, vocab=vocab))
    bwd_ms = time_ms(torch, lambda: cross_entropy_bwd(h, w, tgt, lse, gl, gs, vocab=vocab))
    fwd_plain = time_ms(torch, lambda: ref.cross_entropy_ref(h, w, tgt, vocab), trials=5, per_trial=5)
    bwd_plain = time_ms(torch, lambda: ref.cross_entropy_bwd_ref(h, w, tgt, lse, gl, gs, vocab),
                        trials=5, per_trial=5)
    hl = h.clone().requires_grad_(True)
    wl = w[:, :vocab].clone().requires_grad_(True)
    tl = tgt.long()
    fwd_lib = time_ms(torch, lambda: F.cross_entropy((hl @ wl).float(), tl, reduction="none"))
    lib_loss = F.cross_entropy((hl @ wl).float(), tl, reduction="none")
    bwd_lib = time_ms(torch, lambda: torch.autograd.grad(lib_loss, (hl, wl), gl, retain_graph=True))
    # only the work the function needs: the `vocab` live columns of W (the
    # padded ones give no output but dW's zeros).  Forward: h and W's live
    # columns read, targets read, loss and lse written.  Backward: the same
    # reads plus lse and the two cotangents, dh written and dW written whole
    reads = T * D * 2 + D * vocab * 2 + T * 4
    fwd_bound, fwd_by = bound(2 * T * D * vocab, reads + 2 * T * 4)
    bwd_bound, bwd_by = bound(6 * T * D * vocab, reads + 3 * T * 4 + T * D * 2 + D * Vp * 2)
    print(f"cross_entropy_fwd T={T} D={D} Vpad={Vp} bf16 on {card}: {fwd_ms:.4f} ms (bound "
          f"{fwd_bound:.4f} ms by {fwd_by}), plain {fwd_plain:.4f} ms, F.cross_entropy(h @ W) "
          f"{fwd_lib:.4f} ms")
    print(f"cross_entropy_bwd T={T} D={D} Vpad={Vp} bf16 on {card}: {bwd_ms:.4f} ms (bound "
          f"{bwd_bound:.4f} ms by {bwd_by}), plain {bwd_plain:.4f} ms, F.cross_entropy(h @ W) "
          f"backward {bwd_lib:.4f} ms")
    rec = {"route": "cuda", "source": "src/repro_torch/kernels/csrc/cross_entropy.cu", "launches": 0}
    return [
        dict(rec, name="cross_entropy_fwd", replaces="src/repro/kernels/cross_entropy.py:120",
             max_abs_err=errs0["fwd"], ms=fwd_ms, plain_ms=fwd_plain, bound_ms=fwd_bound,
             bound_by=fwd_by, library_ms=fwd_lib),
        dict(rec, name="cross_entropy_bwd", replaces="src/repro/kernels/cross_entropy.py:266",
             max_abs_err=errs0["bwd"], ms=bwd_ms, plain_ms=bwd_plain, bound_ms=bwd_bound,
             bound_by=bwd_by, library_ms=bwd_lib),
    ]


def train_phase(torch, model, counters, card):
    """The slice: ESM-2 650M MLM pre-training through ``Trainer.run`` at full
    width and depth; returns the launch counts of its run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.config import TrainConfig
    from repro_torch.core.module import tree_leaves
    from repro_torch.core.precision import compute_view
    from repro_torch.data.dataset import build_synthetic_protein_memmap
    from repro_torch.data.pipeline import MLMBatches
    from repro_torch.data.sampler import ClusterSampler, greedy_length_clusters
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.training.loop import Trainer
    from repro_torch.training.train_step import make_train_step

    cfg = model.cfg
    micro, seq, accum, steps = 8, 1024, 2, 10
    tc = TrainConfig(global_batch=micro * accum, seq_len=seq, accum_steps=accum,
                     learning_rate=1e-4, min_lr=1e-5, warmup_steps=2, decay_steps=3,
                     total_steps=steps, schedule="wsd", weight_decay=0.01, beta2=0.98,
                     grad_clip=1.0, log_every=steps)
    tmp = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    ds, tok = build_synthetic_protein_memmap(f"{tmp.name}/prot", n=1024, seed=0,
                                             min_len=100, max_len=1023)
    sampler = ClusterSampler(greedy_length_clusters(ds.lengths(), 64), seed=0)
    pipe = MLMBatches(ds, tok, sampler, tc.global_batch, seq, mask_prob=cfg.mlm_mask_prob, seed=0)
    drawn = []

    def counted():
        for b in pipe:
            drawn.append(int((b["targets"] != tok.pad_id).sum()))
            yield b

    print(f"training data: {len(ds)} synthetic sequences of 100-1022 residues in "
          f"{time.perf_counter() - t0:.1f} s; micro-batch {micro}x{seq}, accum {accum} "
          f"({micro * accum * seq} tokens a step), AdamW + WSD, peak lr {tc.learning_rate}, "
          f"{steps} steps")

    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(model, tc, peak_flops=PEAK_BF16_FLOPS)
    state, hist = trainer.run(counted())
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_micro, L = steps * accum, cfg.num_layers
    want = {"flash_attention_fwd": L * n_micro, "flash_attention_bwd": L * n_micro,
            "layernorm": (2 * L + 1) * n_micro, "cross_entropy_fwd": n_micro,
            "cross_entropy_bwd": n_micro}
    print(f"main path: Trainer.run of {steps} steps x {accum} micro-batches: launches {launches} "
          f"(want {want})")
    # log_every = steps: the trainer flushes after step 0 and after the last
    # step, so steps 1 to the last run as one window with one host transfer
    losses = [h["loss"] for h in hist]
    print(f"losses: step 0 {losses[0]:.4f}, step {steps - 1} {losses[-1]:.4f}")
    # every check of this phase runs and reports before the phase fails
    failed = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    expect(len(hist) == 2 and all(x == x and abs(x) < 1e30 for x in losses), "non-finite loss")
    # a step with a non-finite loss or grad norm is skipped and counted
    expect(trainer.skipped_total == 0, f"{trainer.skipped_total} skipped steps")
    expect(losses[-1] < losses[0], "the loss did not fall")
    expect(launches == want, "training launch counts")

    step_s = hist[-1]["step_time"]
    padded = micro * accum * seq
    real = statistics.mean(drawn) if drawn else 0.0
    mfu = 6 * cfg.active_param_count() * padded / step_s / PEAK_BF16_FLOPS
    print(f"ESM-2 650M MLM training on {card}: step {step_s * 1e3:.1f} ms (wall of steps 1-"
          f"{steps - 1} over {steps - 1}, one host transfer; step 0 with its transfer "
          f"{hist[0]['step_time'] * 1e3:.1f} ms), {real / step_s:.0f} "
          f"real tokens/s, {padded / step_s:.0f} padded tokens/s, MFU {mfu:.4f} "
          f"(6 x {cfg.active_param_count() / 1e6:.0f}M params x padded tokens / 989 TFLOP/s), "
          f"peak memory {peak_gb:.2f} GB")

    # where the time goes: one more optimizer step under the profiler
    batch = {k: torch.from_numpy(v).to(model.device) for k, v in next(iter(pipe)).items()}
    step_fn = make_train_step(model, tc)
    step_fn(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, groups, kern = kernel_groups(prof, DeviceType)
    params = state.params
    leaves = tree_leaves(params)
    grads = [torch.zeros_like(p) for p in leaves]
    never = torch.zeros((), dtype=torch.bool, device=leaves[0].device)
    opt_ms = time_ms(torch, lambda: adamw.apply_updates(
        params, adamw.clip_by_global_norm(grads, 1.0)[0], state.opt, never.float(),
        tc, ok=never), trials=5, per_trial=2, warmup=1)
    del grads
    if busy_ms == 0:
        print("profile: the profiler saw no device time")
    else:
        print(f"profile of one train step on {card}: wall {wall_ms:.1f} ms (under the profiler), "
              f"device busy {busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
        print("profile by group: " + ", ".join(
            f"{k} {v:.1f} ms ({v / busy_ms:.1%})" for k, v in groups.items()))
        for name, t, cnt in sorted(kern, key=lambda r: -r[1])[:14]:
            print(f"  {t:9.2f} ms {cnt:6d}x  {name[:110]}")
    print(f"optimizer (global-norm clip + AdamW over {sum(p.numel() for p in leaves) / 1e6:.0f}M "
          f"fp32 params, part of 'other' above) on {card}: {opt_ms:.1f} ms")

    # one step repeated from the same state and batch: the same bits
    one = make_train_step(model, dataclasses.replace(tc, accum_steps=1))
    mb = {k: v[:micro] for k, v in batch.items()}
    first = trainer.state.clone()
    again = first.clone()
    first, _ = one(first, mb)
    again, _ = one(again, mb)
    torch.cuda.synchronize()
    a_leaves = tree_leaves(first.params) + tree_leaves(first.opt.mu) + tree_leaves(first.opt.nu)
    b_leaves = tree_leaves(again.params) + tree_leaves(again.opt.mu) + tree_leaves(again.opt.nu)
    differ = [i for i, (x, y) in enumerate(zip(a_leaves, b_leaves)) if not torch.equal(x, y)]
    print(f"one step repeated from the same state and batch: {len(differ)} of {len(a_leaves)} "
          f"state leaves differ {differ[:8]}")
    expect(not differ, "a repeated train step is not bit-identical")
    del first, again, a_leaves, b_leaves

    # the kernel path against the plain path: loss and every grad leaf at
    # full width and depth on a 2 x 512 batch
    small = {k: v[:2, :512].contiguous() for k, v in mb.items()}
    plain_model = Model(dataclasses.replace(cfg, kernel_impl="torch"), params)

    def loss_grads(m):
        p = m.params.tree()
        loss, _ = m.loss_fn(compute_view(m.policy, p), small)
        return loss.item(), torch.autograd.grad(loss, tree_leaves(p))

    k_loss, k_grads = loss_grads(model)
    p_loss, p_grads = loss_grads(plain_model)
    cos = [torch.nn.functional.cosine_similarity(a.flatten().double(), b.flatten().double(), dim=0).item()
           for a, b in zip(k_grads, p_grads)]
    names = leaf_paths(params)
    worst = min(range(len(cos)), key=lambda i: cos[i])
    print(f"kernel path vs plain path (loss_fn + backward, 2x512): loss {k_loss:.6f} vs "
          f"{p_loss:.6f} (|diff| {abs(k_loss - p_loss):.3g}, tol 2e-2); grad cosine min "
          f"{cos[worst]:.6f} ({names[worst]}, of {len(cos)} leaves; floor 0.999), mean "
          f"{statistics.mean(cos):.6f}")
    print("lowest grad cosines: " + ", ".join(
        f"{names[i]} {cos[i]:.6f}" for i in sorted(range(len(cos)), key=lambda i: cos[i])[:5]))
    expect(abs(k_loss - p_loss) <= 2e-2, "kernel path loss disagrees with the plain path")
    expect(min(cos) >= 0.999, "kernel path gradients disagree with the plain path")
    tmp.cleanup()
    check(not failed, "training phase: " + "; ".join(failed))
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU", file=sys.stderr)
        return 2

    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.data.tokenizer import ProteinTokenizer
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.cross_entropy import cross_entropy_bwd, cross_entropy_fwd
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd
    from repro_torch.kernels.rmsnorm import layernorm
    from repro_torch.models.model import Model, build_model
    from repro_torch.obs.trace import TraceRecorder
    from repro_torch.serving.api import LLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. the card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # ---- 2. build every kernel: one nvcc per CUDA source, all started
    # together; the Triton norm compiles at its first launch
    t0 = time.perf_counter()
    logs = _build.finish_builds(_build.start_builds(
        ["flash_attention_fwd", "flash_attention_bwd", "cross_entropy"]))
    t_nvcc = time.perf_counter() - t0
    for name, log in logs.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill stores" in ln
                and not ln.strip().startswith("0 bytes")]
        print(f"built {name} in {t_nvcc:.1f} s: " + " | ".join(regs))
    t0 = time.perf_counter()
    xw = torch.ones(8, 1280, device=dev, dtype=torch.bfloat16)
    layernorm(xw, torch.ones(1280, device=dev), torch.zeros(1280, device=dev))
    torch.cuda.synchronize()
    print(f"compiled layernorm (Triton) in {time.perf_counter() - t0:.1f} s")

    # ---- 3. each kernel against its plain version, on the card
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=g, device=dev) * scale + shift).to(dtype)

    # tolerances, for unit-normal inputs: the kernel rounds P to the input
    # dtype before PV (<= 2^-9 relative per probability in bf16) and both
    # round the output once; lse is fp32 from the same fp32 scores
    fa_tol = {torch.bfloat16: 3e-2, torch.float16: 4e-3}
    lse_tol = 1e-4
    fa_cases = [
        ("esm2-650m serving shape", dict(B=32, S=1024, T=1024, H=20, Hkv=20, D=64), dict(causal=False)),
        ("causal", dict(B=2, S=128, T=128, H=4, Hkv=4, D=64), dict(causal=True)),
        ("causal window", dict(B=2, S=200, T=200, H=4, Hkv=4, D=64), dict(causal=True, window=48)),
        ("softcap", dict(B=2, S=96, T=96, H=4, Hkv=4, D=64), dict(causal=False, softcap=20.0)),
        ("gqa H=8 Hkv=2", dict(B=2, S=128, T=128, H=8, Hkv=2, D=64), dict(causal=True)),
        ("D=128", dict(B=2, S=128, T=128, H=4, Hkv=4, D=128), dict(causal=False)),
        ("non-multiple S/T", dict(B=3, S=77, T=131, H=4, Hkv=4, D=64), dict(causal=False)),
        ("q_offset", dict(B=2, S=40, T=104, H=4, Hkv=2, D=128), dict(causal=True, q_offset=64)),
        ("fully-masked rows", dict(B=1, S=24, T=24, H=2, Hkv=2, D=64), dict(causal=True, q_offset=-8)),
    ]
    fa_serving_err = 0.0
    for label, s, kw in fa_cases:
        for dt in (torch.bfloat16, torch.float16):
            q = randn(s["B"], s["S"], s["H"], s["D"], dtype=dt)
            k = randn(s["B"], s["T"], s["Hkv"], s["D"], dtype=dt)
            v = randn(s["B"], s["T"], s["Hkv"], s["D"], dtype=dt)
            out, lse = flash_attention_fwd(q, k, v, **kw)
            torch.cuda.synchronize()
            r_out, r_lse = ref.attention_ref(q, k, v, **kw)
            e_out = (out.float() - r_out.float()).abs().max().item()
            e_lse = (lse - r_lse).abs().max().item()
            print(f"flash_attention_fwd {label} {str(dt)[6:]}: out err {e_out:.3g} "
                  f"(tol {fa_tol[dt]}), lse err {e_lse:.3g} (tol {lse_tol})")
            check(e_out <= fa_tol[dt] and e_lse <= lse_tol, f"flash_attention_fwd {label} {dt}")
            if label.startswith("esm2") and dt == torch.bfloat16:
                fa_serving_err = e_out

    B, S, H, D = 32, 1024, 20, 64
    q, k, v = (randn(B, S, H, D) for _ in range(3))
    fa_ms = time_ms(torch, lambda: flash_attention_fwd(q, k, v, causal=False))
    fa_plain_ms = time_ms(torch, lambda: ref.attention_ref(q, k, v, causal=False))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    fa_lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt))
    fa_flops = 4 * B * H * S * S * D
    fa_bound_ms, fa_bound_by = bound(fa_flops, 4 * B * S * H * D * 2 + B * H * S * 4)
    print(f"flash_attention_fwd B={B} S=T={S} H={H} D={D} bf16 on {card}: {fa_ms:.4f} ms "
          f"(bound {fa_bound_ms:.4f} ms by {fa_bound_by}, {fa_flops / fa_ms / 1e9:.1f} TFLOP/s), "
          f"plain {fa_plain_ms:.4f} ms, scaled_dot_product_attention {fa_lib_ms:.4f} ms")
    del q, k, v, qt, kt, vt

    rows, d = 32 * 1024, 1280
    ln_serving_err = 0.0
    for dt in (torch.bfloat16, torch.float32):
        for bias in (True, False):
            x = randn(rows, d, dtype=dt, scale=3.0, shift=1.0)
            w = randn(d, dtype=torch.float32)
            b = randn(d, dtype=torch.float32) if bias else None
            y = layernorm(x, w, b)
            torch.cuda.synchronize()
            r = ref.layernorm_ref(x, w, b)
            err = (y.float() - r.float()).abs()
            # bf16: at most one output rounding step (2^-8 relative, at most
            # 2^-7 of |y|); fp32: moments summed in another order
            if dt == torch.bfloat16:
                ok = bool((err <= 1e-2 + 2**-7 * r.float().abs()).all())
                tol = "1e-2 + 2^-7*|y|"
            else:
                ok = err.max().item() <= 1e-4
                tol = "1e-4"
            print(f"layernorm ({rows}, {d}) {str(dt)[6:]} bias={bias}: err {err.max().item():.3g} (tol {tol})")
            check(ok, f"layernorm {dt} bias={bias}")
            if dt == torch.bfloat16 and bias:
                ln_serving_err = err.max().item()
    x = randn(rows, d)
    w, b = randn(d, dtype=torch.float32), randn(d, dtype=torch.float32)
    wl, bl = w.to(torch.bfloat16), b.to(torch.bfloat16)
    ln_ms = time_ms(torch, lambda: layernorm(x, w, b))
    ln_plain_ms = time_ms(torch, lambda: ref.layernorm_ref(x, w, b))
    ln_lib_ms = time_ms(torch, lambda: F.layer_norm(x, (d,), wl, bl, 1e-5))
    ln_bound_ms, ln_bound_by = bound(8 * rows * d, 2 * rows * d * 2 + 2 * d * 4, PEAK_FP32_FLOPS)
    print(f"layernorm ({rows}, {d}) bf16 on {card}: {ln_ms:.4f} ms (bound {ln_bound_ms:.4f} ms by {ln_bound_by}, "
          f"{(2 * rows * d * 2 + 2 * d * 4) / ln_ms / 1e6:.0f} GB/s), plain {ln_plain_ms:.4f} ms, "
          f"F.layer_norm {ln_lib_ms:.4f} ms")
    del x

    fa_bwd_rec = check_attention_bwd(torch, F, ref, flash_attention_fwd, flash_attention_bwd,
                                     randn, card)
    ce_recs = check_cross_entropy(torch, F, ref, cross_entropy_fwd, cross_entropy_bwd, randn, g, card)
    torch.cuda.empty_cache()

    # ---- 4. slice 1: ESM-2 650M embedding serving through LLM.embed
    cfg = get_config("esm2-650m")
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    print(f"built {cfg.name} ({cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.param_count() / 1e6:.0f}M params) on cuda in {time.perf_counter() - t0:.1f} s")
    tok = ProteinTokenizer()
    rng = np.random.default_rng(0)
    n = 96
    lengths = rng.integers(30, 1023, size=n)          # tokens incl. <cls> and <eos>
    prompts = [tok.encode("".join(rng.choice(list(AMINO_ACIDS), size=int(L) - 2))) for L in lengths]
    trace = TraceRecorder()
    llm = LLM(model, slots=32, max_len=1024, trace=trace)

    flash_attention_fwd.launches = 0
    layernorm.launches = 0
    trace.clear()
    t0 = time.perf_counter()
    vecs = llm.embed(prompts)
    t_first = time.perf_counter() - t0
    launches = {"flash_attention_fwd": flash_attention_fwd.launches, "layernorm": layernorm.launches}
    buckets = [e["bucket"] for e in trace.events() if e["event"] == "prefill"]
    dispatches = len(buckets)
    print(f"main path: LLM.embed of {n} prompts, {dispatches} dispatches over buckets "
          f"{sorted(set(buckets))}: launches {launches} "
          f"(want {33 * dispatches} and {67 * dispatches})")
    check(vecs.shape == (n, cfg.d_model) and vecs.dtype == np.float32, f"shape {vecs.shape} {vecs.dtype}")
    check(bool(np.isfinite(vecs).all()), "non-finite embeddings")
    check(launches["flash_attention_fwd"] == 33 * dispatches, "attention launches")
    check(launches["layernorm"] == 67 * dispatches, "layernorm launches")

    t0 = time.perf_counter()
    again = llm.embed(prompts)
    t_steady = time.perf_counter() - t0
    check(np.array_equal(vecs, again), "second embed call differs")
    print("second call: bit-identical")

    alone = np.stack([llm.embed([prompts[i]])[0] for i in (0, 1, 2, 3)])
    e_alone = float(np.abs(alone - vecs[:4]).max())
    # every dispatch has the same (slots, bucket) shape, so a row's result
    # should not move with its batch mates; 1e-4 leaves room for a GEMM
    # that splits its work by batch
    print(f"batch-composition independence: max |alone - together| {e_alone:.3g} (tol 1e-4)")
    check(e_alone <= 1e-4, "embedding depends on batch mates")

    plain_model = Model(dataclasses.replace(cfg, kernel_impl="torch"), model.params.tree())
    t0 = time.perf_counter()
    plain = LLM(plain_model, slots=32, max_len=1024).embed(prompts)
    t_plain = time.perf_counter() - t0
    cos = (vecs * plain).sum(1) / (np.linalg.norm(vecs, axis=1) * np.linalg.norm(plain, axis=1))
    print(f"kernel path vs plain path: min cosine {cos.min():.7f} (tol >= 0.9999), "
          f"max abs diff {np.abs(vecs - plain).max():.3g}, plain path {t_plain:.2f} s")
    check(bool((cos >= 0.9999).all()), "kernel path disagrees with the plain path")
    del plain_model

    real_tokens = int(lengths.sum())
    padded_tokens = 32 * sum(buckets)
    print(f"ESM-2 650M LLM.embed on {card}: {n / t_steady:.1f} sequences/s, "
          f"{real_tokens / t_steady:.0f} tokens/s ({padded_tokens / t_steady:.0f} padded tokens/s; "
          f"{n} sequences, {real_tokens} tokens, {t_steady:.3f} s; first call {t_first:.3f} s)")

    # ---- 5. where the embed time goes: one more call under the profiler
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        llm.embed(prompts)
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, groups, kern = kernel_groups(prof, DeviceType)
    if busy_ms == 0:
        print("profile: the profiler saw no device time")
    else:
        print(f"profile of one embed call on {card}: wall {wall_ms:.1f} ms (under the profiler), "
              f"device busy {busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
        print("profile by group: " + ", ".join(
            f"{k} {v:.1f} ms ({v / busy_ms:.1%})" for k, v in groups.items() if v))
        for name, t, cnt in sorted(kern, key=lambda r: -r[1])[:12]:
            print(f"  {t:9.2f} ms {cnt:6d}x  {name[:110]}")
    del llm, prof

    # ---- 6. slice 2: ESM-2 650M MLM pre-training through Trainer.run
    counters = {"flash_attention_fwd": flash_attention_fwd, "flash_attention_bwd": flash_attention_bwd,
                "layernorm": layernorm, "cross_entropy_fwd": cross_entropy_fwd,
                "cross_entropy_bwd": cross_entropy_bwd}
    train_launches = train_phase(torch, model, counters, card)

    # launches: the training run's (this slice's main path); the embed
    # run's counts were checked in phase 4
    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
         "replaces": "src/repro/kernels/flash_attention.py:211",
         "launches": 0, "max_abs_err": fa_serving_err,
         "ms": fa_ms, "plain_ms": fa_plain_ms, "bound_ms": fa_bound_ms,
         "bound_by": fa_bound_by, "library_ms": fa_lib_ms},
        fa_bwd_rec,
        *ce_recs,
        {"name": "layernorm", "route": "triton",
         "source": "src/repro_torch/kernels/rmsnorm.py",
         "replaces": "src/repro/kernels/rmsnorm.py:83",
         "launches": 0, "max_abs_err": ln_serving_err,
         "ms": ln_ms, "plain_ms": ln_plain_ms, "bound_ms": ln_bound_ms,
         "bound_by": ln_bound_by, "library_ms": ln_lib_ms},
    ]
    for rec in kernels:
        rec["launches"] = train_launches[rec["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
