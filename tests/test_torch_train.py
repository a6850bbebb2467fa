"""The port's training path against the reference package on bridged
weights and the same seeded numpy batches: ``Model.loss_fn`` and every
gradient leaf, AdamW and the lr schedules, 5 steps of ``make_train_step``
(accum 1 and 4), the non-finite guard, the data draws, checkpoints across
the two packages, and ``Trainer.run``.

fp32 runs against the reference's default CPU path; bf16 against the
reference with REPRO_FORCE_IMPL=pallas_interpret (its TPU kernels' own
math), as in the model tests."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.checkpoint import ckpt as jax_ckpt  # noqa: E402
from repro.core.config import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.core.precision import compute_view as jax_compute_view  # noqa: E402
from repro.data import dataset as jax_dataset  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.data import sampler as jax_sampler  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.optim.schedule import lr_at as jax_lr_at  # noqa: E402
from repro.training import train_step as jax_ts  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.checkpoint.bridge import from_jax_params  # noqa: E402
from repro_torch.core.config import ModelConfig, TrainConfig  # noqa: E402
from repro_torch.core.module import tree_leaves  # noqa: E402
from repro_torch.core.precision import compute_view  # noqa: E402
from repro_torch.data import dataset, pipeline, sampler  # noqa: E402
from repro_torch.data.tokenizer import ProteinTokenizer  # noqa: E402
from repro_torch.kernels import cross_entropy as ce  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models.model import Model, build_model  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.schedule import lr_at  # noqa: E402
from repro_torch.training import loop  # noqa: E402
from repro_torch.training.train_step import TrainState, init_train_state, make_train_step  # noqa: E402
from test_torch_model import _params  # noqa: E402

TOK = ProteinTokenizer()
TC = dict(global_batch=8, seq_len=24, learning_rate=1e-3, warmup_steps=2, decay_steps=2,
          total_steps=5, weight_decay=0.1)


def _configs(dtype="float32", **over):
    jcfg = dataclasses.replace(jax_configs.get_smoke_config("esm2-650m"), dtype=dtype,
                               param_dtype="float32", **over)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _batches(n, seed=0, B=8, S=24):
    """MLM batches of random residues with <cls>/<eos> and some padding."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(5, 25, size=(B, S)).astype(np.int32)
        toks[:, 0], toks[:, -1] = 1, 2
        toks[1, S - 6:] = 0
        out.append(pipeline.mlm_corrupt(toks, TOK, rng, 0.3))
    return out


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _state_leaves(state):
    return tree_leaves(state.params) + tree_leaves(state.opt.mu) + tree_leaves(state.opt.nu)


# ------------------------------------------------------------ loss + grads
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_fn_and_every_grad_leaf_match_reference(dtype, monkeypatch):
    if dtype == "bfloat16":
        monkeypatch.setenv("REPRO_FORCE_IMPL", "pallas_interpret")
    jcfg, cfg = _configs(dtype)
    tree = _params(jcfg)
    batch = _batches(1, seed=1)[0]
    jmodel = jax_build_model(jcfg)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(jax_compute_view(jmodel.policy, p), _j(batch)), has_aux=True))(tree)
    model = Model(cfg, from_jax_params(tree))
    params = model.params.tree()
    loss, metrics = model.loss_fn(compute_view(model.policy, params), _t(batch))
    grads = torch.autograd.grad(loss, tree_leaves(params))
    assert float(metrics["tokens"]) == float(jm["tokens"]) == batch["loss_mask"].sum()
    want_leaves = jax.tree.leaves(jgrads)
    assert len(grads) == len(want_leaves)
    if dtype == "float32":
        # the same fp32 math in another summation order (measured: loss
        # 2.4e-7, every leaf within 1e-6 of its largest element)
        assert abs(loss.item() - float(jloss)) <= 1e-5
        for g, w in zip(grads, want_leaves):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * np.abs(w).max(), rtol=0)
        return
    # bf16: each framework rounds every matmul, bias add, GELU and residual
    # to bf16 on its own, forward and backward; measured loss 1.7e-4, every
    # leaf within 3% of its largest element and cosine >= 0.9998
    assert abs(loss.item() - float(jloss)) <= 2e-3
    for g, w in zip(grads, want_leaves):
        g, w = g.numpy(), np.asarray(w, np.float32)
        assert np.abs(g - w).max() <= 0.06 * np.abs(w).max()
        assert (g * w).sum() / np.linalg.norm(g) / np.linalg.norm(w) >= 0.999


def test_clm_loss_and_logits_match_reference():
    jcfg, cfg = _configs(objective="clm", causal=True, logit_softcap=30.0)
    tree = _params(jcfg)
    batch = {k: v for k, v in _batches(1, seed=2)[0].items() if k != "targets"}
    jmodel = jax_build_model(jcfg)
    jloss, _ = jmodel.loss_fn(tree, _j(batch))
    model = Model(cfg, from_jax_params(tree))
    loss, _ = model.loss_fn(model.params.tree(), _t(batch))
    assert abs(loss.item() - float(jloss)) <= 1e-5
    h = np.random.default_rng(3).standard_normal((5, cfg.d_model)).astype(np.float32)
    want = np.asarray(jmodel.logits(tree, jnp.asarray(h)))
    got = model.logits(model.params.tree(), torch.from_numpy(h)).detach().numpy()
    assert (got[:, cfg.vocab_size:] == -1e30).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_moe_config_raises():
    """An MoE model builds and serves, but its loss (router terms, the
    grouped-matmul backward) waits for the MoE training path."""
    _, cfg = _configs()
    model = build_model(dataclasses.replace(cfg, family="moe", num_experts=4), device="cpu")
    toks = torch.ones((2, 8), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="MoE"):
        model.loss_fn(model.params.tree(), {"tokens": toks, "targets": toks,
                                            "loss_mask": torch.ones((2, 8))})


# ------------------------------------------------------------ optimizer
def test_adamw_matches_reference_and_decays_stacked_norm_leaves():
    rng = np.random.default_rng(4)
    tree = {"final_norm": {"scale": rng.standard_normal(8)},
            "layers": {"norm1": {"scale": rng.standard_normal((3, 8))},
                       "w": rng.standard_normal((3, 8, 4))}}
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    kw = dict(weight_decay=0.1, beta1=0.9, beta2=0.95, eps=1e-8)
    jstate, jparams = jax_adamw.init_state(tree), tree
    params = from_jax_params(tree)
    state = adamw.init_state(params)
    for i in range(3):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
        lr = np.float32(0.01 * (i + 1))
        jparams, jstate = jax_adamw.apply_updates(jparams, g, jstate, jnp.float32(lr),
                                                  JaxTrainConfig(**kw))
        state = adamw.apply_updates(params, tree_leaves(from_jax_params(g)), state,
                                    torch.tensor(lr), TrainConfig(**kw))
    assert int(state.step) == int(jstate.step) == 3
    for got, want in zip(tree_leaves(params) + tree_leaves(state.mu) + tree_leaves(state.nu),
                         jax.tree.leaves(jparams) + jax.tree.leaves(jstate.mu)
                         + jax.tree.leaves(jstate.nu)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6, atol=1e-7)
    # the reference's quirk, kept: zero grads still move the (3, 8) stacked
    # norm scale through decay, and leave the (8,) final norm alone
    zeros = [torch.zeros_like(p) for p in tree_leaves(params)]
    fresh = adamw.init_state(params)
    before = [p.clone() for p in tree_leaves(params)]
    adamw.apply_updates(params, zeros, fresh, torch.tensor(0.1), TrainConfig(**kw))
    after = tree_leaves(params)
    assert torch.equal(after[0], before[0])                  # final_norm/scale
    assert not torch.equal(after[1], before[1])              # layers/norm1/scale


def test_clip_by_global_norm_matches_reference():
    g = {"a": np.full((4,), 10.0, np.float32), "b": np.arange(6, dtype=np.float32).reshape(2, 3)}
    jclipped, jgn = jax_adamw.clip_by_global_norm(g, 1.0)
    clipped, gn = adamw.clip_by_global_norm(tree_leaves(from_jax_params(g)), 1.0)
    assert abs(gn.item() - float(jgn)) <= 1e-5
    for a, b in zip(clipped, jax.tree.leaves(jclipped)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("schedule", ["wsd", "cosine", "noam", "const"])
def test_lr_schedules_match_reference(schedule):
    kw = dict(schedule=schedule, learning_rate=3e-4, min_lr=3e-5, warmup_steps=4,
              decay_steps=5, total_steps=20)
    jtc, tc = JaxTrainConfig(**kw), TrainConfig(**kw)
    for s in range(0, 26):
        want = float(jax_lr_at(jtc, s))
        assert lr_at(tc, torch.tensor(s, dtype=torch.int32)).item() == pytest.approx(
            want, rel=1e-6, abs=1e-12), (schedule, s)


# ------------------------------------------------------------ train step
@pytest.mark.parametrize("accum", [1, 4])
def test_five_train_steps_match_reference(accum):
    jcfg, cfg = _configs()
    tree = _params(jcfg)
    batches = _batches(5, seed=5)
    jtc, tc = JaxTrainConfig(accum_steps=accum, **TC), TrainConfig(accum_steps=accum, **TC)
    jstep = jax.jit(jax_ts.make_train_step(jax_build_model(jcfg), jtc))
    jstate = jax_ts.TrainState(tree, jax_adamw.init_state(tree))
    model = Model(cfg, from_jax_params(tree))
    state, step = init_train_state(model), make_train_step(model, tc)
    for b in batches:
        jstate, jm = jstep(jstate, _j(b))
        state, m = step(state, _t(b))
        # fp32 in both; measured at most 5e-7 apart
        assert abs(m["loss"].item() - float(jm["loss"])) <= 1e-5
        assert abs(m["grad_norm"].item() - float(jm["grad_norm"])) <= 1e-4 * float(jm["grad_norm"])
        assert m["lr"].item() == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(state.opt.step) == int(jstate.opt.step) == 5
    # Adam divides by sqrt(v): grads that differ in the last bits move a
    # near-zero-gradient weight by up to ~lr; measured at most 2.8e-5
    want = jax.tree.leaves(jstate.params) + jax.tree.leaves(jstate.opt.mu) \
        + jax.tree.leaves(jstate.opt.nu)
    for got, w in zip(_state_leaves(state), want):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(w), atol=1e-4, rtol=0)
    # the trainer trains the model in place
    assert model.params.tree()["embed"]["tok"] is state.params["embed"]["tok"]


def test_accum_requires_a_divisible_batch():
    _, cfg = _configs()
    model = Model(cfg, from_jax_params(_params(_configs()[0])))
    step = make_train_step(model, TrainConfig(accum_steps=3, **TC))
    with pytest.raises(ValueError, match="not divisible"):
        step(init_train_state(model), _t(_batches(1)[0]))


def test_nonfinite_step_withholds_update():
    jcfg, cfg = _configs()
    model = Model(cfg, from_jax_params(_params(jcfg)))
    step = make_train_step(model, TrainConfig(**TC))
    b = _t(_batches(1, seed=6)[0])
    state, m1 = step(init_train_state(model), b)
    assert m1["skipped"].item() == 0.0 and int(state.opt.step) == 1
    with torch.no_grad():
        state.params["layers"]["sub0"]["attn"]["wq"][0, 0, 0] = float("nan")
    before = [t.detach().clone() for t in _state_leaves(state)]
    state, m2 = step(state, b)
    assert m2["skipped"].item() == 1.0 and not np.isfinite(m2["loss"].item())
    assert int(state.opt.step) == 1                       # did not advance
    for got, want in zip(_state_leaves(state), before):
        assert torch.equal(got.detach(), want) or (torch.isnan(got) == torch.isnan(want)).all()
        assert torch.equal(torch.nan_to_num(got.detach()), torch.nan_to_num(want))


# ------------------------------------------------------------ data
def test_data_draws_match_reference(tmp_path):
    prefix = str(tmp_path / "prot")
    jds, jtok = jax_dataset.build_synthetic_protein_memmap(prefix + "_j", n=120, seed=3)
    ds, tok = dataset.build_synthetic_protein_memmap(prefix + "_t", n=120, seed=3)
    assert len(ds) == len(jds) and all(np.array_equal(ds[i], jds[i]) for i in range(len(ds)))
    assert dataset.synthetic_protein_sequences(20, 100, 1022, seed=9) == \
        jax_dataset.synthetic_protein_sequences(20, 100, 1022, seed=9)
    lengths = ds.lengths()
    assert jax_sampler.greedy_length_clusters(lengths, 8) == sampler.greedy_length_clusters(lengths, 8)
    jsamp = jax_sampler.ClusterSampler(jax_sampler.greedy_length_clusters(lengths, 8), seed=1)
    samp = sampler.ClusterSampler(sampler.greedy_length_clusters(lengths, 8), seed=1)
    assert np.array_equal(samp.sample(50), jsamp.sample(50))
    jb = iter(jax_pipeline.MLMBatches(jds, jtok, jsamp, 4, 64, mask_prob=0.15, seed=2))
    tb = iter(pipeline.MLMBatches(ds, tok, samp, 4, 64, mask_prob=0.15, seed=2))
    for _ in range(3):
        a, b = next(tb), next(jb)
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    rng_a, rng_b = np.random.default_rng(7), np.random.default_rng(7)
    toks = np.zeros((3, 10), np.int32)
    toks[:, 0] = 1                                       # rows with no residue: no target
    toks[0, 1:5] = [6, 7, 8, 2]
    a = pipeline.mlm_corrupt(toks, tok, rng_a, 0.0)
    b = jax_pipeline.mlm_corrupt(toks, jtok, rng_b, 0.0)
    assert all(np.array_equal(a[k], b[k]) for k in a) and a["loss_mask"][0].sum() == 1


# ------------------------------------------------------------ checkpoints
def _trained_state(seed=7, steps=2):
    jcfg, cfg = _configs()
    model = Model(cfg, from_jax_params(_params(jcfg)))
    state, step = init_train_state(model), make_train_step(model, TrainConfig(**TC))
    for b in _batches(steps, seed=seed):
        state, _ = step(state, _t(b))
    return jcfg, model, state, step


def test_checkpoints_cross_between_the_packages(tmp_path):
    jcfg, model, state, _ = _trained_state()
    ckpt.save_train_state(str(tmp_path / "port"), state, 2, extra={"cursor": 5})
    jmodel = jax_build_model(jcfg)
    jstate, jstep, jextra = jax_ckpt.restore_train_state(
        str(tmp_path / "port"), jax_ts.abstract_train_state(jmodel))
    assert jstep == 2 and jextra == {"cursor": 5} and int(jstate.opt.step) == 2
    want = jax.tree.leaves(jstate.params) + jax.tree.leaves(jstate.opt.mu) \
        + jax.tree.leaves(jstate.opt.nu)
    for got, w in zip(_state_leaves(state), want):
        assert np.array_equal(got.detach().numpy(), np.asarray(w))
    # and back: the reference's save restores in the port, bf16 leaves too
    jtree = dict(jstate.params, extra_bf16=jnp.asarray(np.arange(6, dtype=np.float32), jnp.bfloat16))
    jax_ckpt.save(str(tmp_path / "ref"), {"params": jtree, "opt": jstate.opt}, 2)
    back = ckpt.restore(str(tmp_path / "ref"), {"params": dict(state.params, extra_bf16=None),
                                                "opt": state.opt})
    assert back["params"]["extra_bf16"].dtype == torch.bfloat16
    assert back["params"]["extra_bf16"].float().tolist() == list(range(6))
    for got, w in zip(tree_leaves({k: v for k, v in back["params"].items() if k != "extra_bf16"}),
                      tree_leaves(state.params)):
        assert torch.equal(got, w.detach())


def test_save_restore_continue_equals_uninterrupted(tmp_path):
    _, model, state, step = _trained_state(steps=2)
    ckpt.save_train_state(str(tmp_path / "step_2"), state, 2)
    assert ckpt.latest_step(str(tmp_path)) == str(tmp_path / "step_2")
    restored, s, _ = ckpt.restore_train_state(str(tmp_path / "step_2"), model.params.tree())
    assert s == 2
    rest = _batches(2, seed=8)
    for b in rest:
        state, _ = step(state, _t(b))
        restored, _ = step(restored, _t(b))
    for a, b in zip(_state_leaves(state), _state_leaves(restored)):
        assert torch.equal(a.detach(), b.detach())


# ------------------------------------------------------------ trainer
def test_trainer_run_history_resume_and_counters(tmp_path):
    jcfg, cfg = _configs()
    tree = _params(jcfg)
    ds, tok = dataset.build_synthetic_protein_memmap(str(tmp_path / "prot"), n=64, seed=0)
    samp = lambda: sampler.ClusterSampler(sampler.greedy_length_clusters(ds.lengths(), 8))  # noqa: E731
    pipe = lambda: pipeline.MLMBatches(ds, tok, samp(), 8, 32, seed=1)  # noqa: E731
    tc = TrainConfig(**dict(TC, seq_len=32, total_steps=4, log_every=2, accum_steps=2,
                            ckpt_every=2, ckpt_dir=str(tmp_path / "ckpt")))
    reg = MetricsRegistry()
    seen = []
    tr = loop.Trainer(Model(cfg, from_jax_params(tree)), tc, verbose=False, peak_flops=1e12,
                      metrics=reg, hooks=[lambda s, m: seen.append(s)])
    state, hist = tr.run(pipe())
    assert [h["step"] for h in hist] == seen == [0, 2, 3]
    assert tr.step_idx == 4 and int(state.opt.step) == 4 and tr.skipped_total == 0
    assert all(np.isfinite(h["loss"]) and h["tokens_per_sec"] > 0 and h["mfu"] > 0 for h in hist)
    assert reg.get("train_steps_total").value == 4
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["step_2", "step_4"]
    # resume from step 2 onto fresh weights: the same last two steps
    tr2 = loop.Trainer(Model(cfg, from_jax_params(tree)), tc, verbose=False)
    state2, hist2 = tr2.run(pipe(), resume_from=str(tmp_path / "ckpt" / "step_2"))
    assert hist2[-1]["loss"] == hist[-1]["loss"]
    for a, b in zip(_state_leaves(state), _state_leaves(state2)):
        assert torch.equal(a.detach(), b.detach())
    assert tr2.metrics is None and fa.flash_attention_bwd.launches == 0 \
        and ce.cross_entropy_bwd.launches == 0                # CPU: plain versions


def test_trainer_fetches_metrics_once_per_log_interval(monkeypatch):
    """Steps queue their metrics on the device; each log flush copies them
    to the host with one ``.cpu()``, and nothing reads a tensor's value
    (``.item()``) in between."""
    jcfg, cfg = _configs()
    tr = loop.Trainer(Model(cfg, from_jax_params(_params(jcfg))),
                      TrainConfig(**dict(TC, total_steps=6, log_every=3)), verbose=False)
    tr.prepare(iter(_batches(6, seed=10)))
    calls = {"cpu": 0, "item": 0}
    real_cpu, real_item = torch.Tensor.cpu, torch.Tensor.item

    def counted(name, real):
        def f(self, *a, **k):
            calls[name] += 1
            return real(self, *a, **k)
        return f

    monkeypatch.setattr(torch.Tensor, "cpu", counted("cpu", real_cpu))
    monkeypatch.setattr(torch.Tensor, "item", counted("item", real_item))
    for _ in range(6):
        tr.step()
    assert [h["step"] for h in tr.history] == [0, 3, 5]
    assert calls == {"cpu": 3, "item": 0}


def test_trainer_aborts_after_consecutive_nonfinite(tmp_path):
    jcfg, cfg = _configs()
    model = Model(cfg, from_jax_params(_params(jcfg)))
    with torch.no_grad():
        for p in tree_leaves(model.params.tree()):
            p.fill_(float("nan"))
    tc = TrainConfig(**dict(TC, total_steps=10, log_every=1, max_nonfinite_skips=3))
    tr = loop.Trainer(model, tc, verbose=False).prepare(iter(_batches(10, seed=9)))
    with pytest.raises(loop.NonFiniteLossError) as ei:
        while tr.step_idx < tc.total_steps:
            tr.step()
    assert ei.value.skips == 3 and ei.value.step == 2 and tr.skipped_total == 3


def test_train_state_clone_is_a_deep_copy():
    state = TrainState({"w": torch.zeros(2, requires_grad=True)},
                       adamw.init_state({"w": torch.zeros(2)}))
    c = state.clone()
    assert torch.equal(c.params["w"], state.params["w"]) and c.params["w"].requires_grad
    assert c.params["w"].data_ptr() != state.params["w"].data_ptr()
