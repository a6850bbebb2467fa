"""The port's MoE training path against the reference on the CPU: the plain
ragged weight gradient against the reference's ``gmm_dw`` kernel in Pallas
interpret mode; ``Model.loss_fn`` with the router terms, its router metrics
and every gradient leaf against ``jax.grad`` of the reference's, for
reduced Llama-4 Scout and Maverick on bridged weights; 5 train steps with
bf16 AdamW moments (accum 1 and 2); the packed causal-LM batches and their
cursor; the chunked AdamW and in-place clip against a one-shot update; and
the trainer's router metrics.

fp32 runs against the reference's default CPU path (its XLA grouped
matmul); the one bf16 case against REPRO_FORCE_IMPL=pallas_interpret (its
TPU kernels' own math, the grouped matmul's backward kernels included)."""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.core.config import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.core.config import reduced as jax_reduced  # noqa: E402
from repro.core.precision import compute_view as jax_compute_view  # noqa: E402
from repro.data import dataset as jax_dataset  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.kernels.grouped_matmul import gmm_dw as jax_gmm_dw  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.training import train_step as jax_ts  # noqa: E402
from repro_torch.checkpoint.bridge import from_jax_params  # noqa: E402
from repro_torch.core.config import ModelConfig, ParallelConfig, TrainConfig  # noqa: E402
from repro_torch.core.module import tree_leaves  # noqa: E402
from repro_torch.core.precision import compute_view  # noqa: E402
from repro_torch.data import dataset, pipeline  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.training import loop  # noqa: E402
from repro_torch.training.train_step import init_train_state, make_train_step  # noqa: E402

SCOUT, MAVERICK = "llama4-scout-17b-a16e", "llama4-maverick-400b-a17b"
ROUTER = ("aux_loss", "router_entropy", "router_drop_frac", "router_load")


def _size_cases(E, M):
    """Ragged edge cases for E groups over at most M rows (the reference
    MoE tests' cases): even, Dirichlet-uneven, all empty, one group takes
    all, a dropped tail, interior empty groups."""
    rng = np.random.default_rng(E)
    cases = [[M // E] * E, rng.multinomial(M, rng.dirichlet(np.ones(E))).tolist(), [0] * E,
             [M] + [0] * (E - 1), [M // 2] + [0] * (E - 1)]
    if E >= 3:
        cases.append([0, M // 4, 0] + [(M // 2) // (E - 3)] * (E - 3))
    return cases


# ------------------------------------------------------------ gmm_dw
@pytest.mark.parametrize("E,M", [(2, 64), (8, 64), (16, 50)])
def test_plain_gmm_dw_matches_pallas_gmm_dw(E, M):
    """``grouped_matmul_dw_ref`` against the reference's ``gmm_dw`` kernel
    (interpret mode, jitted once per shape with the sizes traced) in every
    size case; M = 50 is no multiple of a tile.  Large values in the rows
    past the groups must not reach the sums."""
    K, N = 16, 24
    rng = np.random.default_rng(E + M)
    x = rng.standard_normal((M, K)).astype(np.float32)
    dy = rng.standard_normal((M, N)).astype(np.float32)
    want_fn = jax.jit(functools.partial(jax_gmm_dw, interpret=True))
    for sizes in _size_cases(E, M):
        total = sum(sizes)
        xt, dyt = x.copy(), dy.copy()
        xt[total:], dyt[total:] = 1e30, -1e30      # the dropped tail
        gs = np.asarray(sizes, np.int32)
        got = ref.grouped_matmul_dw_ref(torch.from_numpy(xt), torch.from_numpy(dyt),
                                        torch.from_numpy(gs))
        want = np.asarray(want_fn(jnp.asarray(x), jnp.asarray(dy), jnp.asarray(gs)))
        assert got.dtype == torch.float32 and got.shape == (E, K, N)
        # the same fp32 products summed in another order
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0, err_msg=str(sizes))
        for g in np.flatnonzero(gs == 0):
            assert (got[g] == 0).all(), (sizes, g)


# ------------------------------------------------------------ model loss + grads
def _jcfg(name, dtype="float32"):
    # a non-zero entropy coefficient, so the deficit's gradient is held too
    return jax_reduced(jax_configs.get_config(name), dtype=dtype, param_dtype="float32",
                       router_entropy_coef=0.01)


def _tree(jcfg, seed=0):
    """Reference init with the norm scales perturbed, so every scale
    matters."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(seed)))
    return jax.tree.map(
        lambda a: a + (0.1 * rng.standard_normal(a.shape)).astype(a.dtype) if a.ndim <= 2 else a,
        tree)


def _tokens(n, seed, B=4, S=24, vocab=500):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, vocab, size=(B, S)).astype(np.int32)} for _ in range(n)]


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("name,dtype", [(SCOUT, "float32"), (MAVERICK, "float32"),
                                        (SCOUT, "bfloat16")])
def test_moe_loss_router_metrics_and_every_grad_leaf_match_reference(name, dtype, monkeypatch):
    if dtype == "bfloat16":
        monkeypatch.setenv("REPRO_FORCE_IMPL", "pallas_interpret")
    jcfg = _jcfg(name, dtype)
    tree = _tree(jcfg)
    batch = _tokens(1, seed=3)[0]
    jmodel = jax_build_model(jcfg)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(jax_compute_view(jmodel.policy, p), _j(batch)), has_aux=True))(tree)
    model = Model(ModelConfig(**dataclasses.asdict(jcfg)), from_jax_params(tree))
    params = model.params.tree()
    loss, m = model.loss_fn(compute_view(model.policy, params), _t(batch))
    grads = torch.autograd.grad(loss, tree_leaves(params))
    want_leaves = jax.tree.leaves(jgrads)
    assert len(grads) == len(want_leaves)
    assert m["router_load"].shape == (jcfg.num_experts,)
    # the tight reduced capacity drops slots on these batches
    assert 0.0 < m["router_drop_frac"].item() == pytest.approx(float(jm["router_drop_frac"]))
    if dtype == "float32":
        # the same fp32 math in another summation order (measured: loss and
        # router metrics within 2.4e-7, every leaf within 5.9e-6 of its
        # largest element)
        assert abs(loss.item() - float(jloss)) <= 1e-5
        for k in ROUTER + ("ce_loss",):
            np.testing.assert_allclose(m[k].detach().numpy(), np.asarray(jm[k]), atol=1e-5,
                                       rtol=0, err_msg=k)
        for g, w in zip(grads, want_leaves):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * np.abs(w).max(), rtol=0)
        return
    # bf16: each framework rounds every matmul, activation and residual to
    # bf16 on its own, forward and backward; the routing itself is fp32
    # from the bf16 activations, so both put every token on the same expert
    # (measured: loss 7.9e-4 apart, lb 1.2e-4, every leaf within 1.7% of its
    # largest element, about two bf16 steps, and cosine >= 0.99989)
    np.testing.assert_array_equal(m["router_load"].detach().numpy(),
                                  np.asarray(jm["router_load"]))
    assert abs(loss.item() - float(jloss)) <= 2e-3
    for k in ROUTER[:3]:
        assert abs(m[k].item() - float(jm[k])) <= 2e-3 * max(1.0, abs(float(jm[k]))), k
    for g, w in zip(grads, want_leaves):
        g, w = g.numpy(), np.asarray(w, np.float32)
        assert np.abs(g - w).max() <= 0.06 * np.abs(w).max()
        assert (g * w).sum() / np.linalg.norm(g) / np.linalg.norm(w) >= 0.999


# ------------------------------------------------------------ train steps
@pytest.mark.parametrize("accum", [1, 2])
def test_five_train_steps_with_bf16_moments_match_reference(accum):
    jcfg = _jcfg(SCOUT)
    tree = _tree(jcfg)
    kw = dict(global_batch=4, seq_len=24, learning_rate=1e-3, warmup_steps=2, decay_steps=2,
              total_steps=5, weight_decay=0.1, accum_steps=accum)
    jstep = jax.jit(jax_ts.make_train_step(jax_build_model(jcfg), JaxTrainConfig(**kw)))
    jstate = jax_ts.TrainState(tree, jax_adamw.init_state(tree, jnp.bfloat16))
    model = Model(ModelConfig(**dataclasses.asdict(jcfg)), from_jax_params(tree))
    state = init_train_state(model, ParallelConfig(optimizer_state_dtype="bfloat16"))
    step = make_train_step(model, TrainConfig(**kw))
    for b in _tokens(5, seed=5):
        jstate, jm = jstep(jstate, _j(b))
        state, m = step(state, _t(b))
        assert abs(m["loss"].item() - float(jm["loss"])) <= 1e-5
        assert abs(m["grad_norm"].item() - float(jm["grad_norm"])) <= 1e-4 * float(jm["grad_norm"])
        for k in ROUTER:   # averaged over the micro-batches with accum 2
            np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]), atol=1e-5, rtol=0,
                                       err_msg=k)
    assert int(state.opt.step) == int(jstate.opt.step) == 5
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(state.opt.mu))
    # params in fp32: Adam moves a near-zero-gradient weight by up to ~lr
    # when the grads differ in their last bits
    for got, w in zip(tree_leaves(state.params), jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(w), atol=1e-4, rtol=0)
    # bf16 moments, rounded at every step: a last-bit difference in the
    # fp32 grads can round an intermediate moment to either bf16 neighbour,
    # so an element that later cancels towards 0 keeps up to one bf16 step
    # of the leaf's scale (measured: 59 of 131 072 elements of one leaf past
    # 1e-6 of its max, by at most 3.8e-6 on a max of 1.6e-3)
    for got, w in zip(tree_leaves(state.opt.mu) + tree_leaves(state.opt.nu),
                      jax.tree.leaves(jstate.opt.mu) + jax.tree.leaves(jstate.opt.nu)):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(got.float().numpy(), w, rtol=2 ** -7,
                                   atol=2 ** -7 * np.abs(w).max())


# ------------------------------------------------------------ CLM batches
class _StubSampler:
    """A sampler with ``sample_batch`` (the bucketed mode's duck type):
    draws row indices and a bucket length from its own seeded Generator."""

    def __init__(self, n, seed=0):
        self.n, self.rng = n, np.random.default_rng(seed)

    def sample_batch(self):
        return self.rng.integers(0, self.n, size=3), int(self.rng.choice([16, 32, 48]))

    def state_dict(self):
        return {"rng": self.rng.bit_generator.state}

    def load_state_dict(self, st):
        self.rng.bit_generator.state = st["rng"]


def test_clm_batches_draw_and_resume_as_the_reference(tmp_path):
    ds, tok = dataset.build_synthetic_protein_memmap(str(tmp_path / "t"), n=64, seed=0)
    jds, jtok = jax_dataset.build_synthetic_protein_memmap(str(tmp_path / "j"), n=64, seed=0)
    assert tok.eos_id == jtok.eos_id
    for eos in (None, tok.eos_id):
        ours = pipeline.CLMBatches(ds, 3, 40, seed=1, eos_id=eos)
        theirs = jax_pipeline.CLMBatches(jds, 3, 40, seed=1, eos_id=eos)
        a, b = iter(ours), iter(theirs)
        for _ in range(4):
            np.testing.assert_array_equal(next(a)["tokens"], next(b)["tokens"])
        cur = ours.state_dict()
        assert cur["buf"] == theirs.state_dict()["buf"]
        after = [next(a)["tokens"] for _ in range(3)]
        # a cursor taken by either package resumes the other's stream
        for src in (cur, theirs.state_dict()):
            resumed = pipeline.CLMBatches(ds, 3, 40, seed=99, eos_id=eos)
            resumed.load_state_dict(src)
            it = iter(resumed)
            got = [next(it)["tokens"] for _ in range(3)]
            want = after if src is cur else [next(b)["tokens"] for _ in range(3)]
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    ours = iter(pipeline.CLMBatches(ds, 3, 40, sampler=_StubSampler(64)))
    theirs = iter(jax_pipeline.CLMBatches(jds, 3, 40, sampler=_StubSampler(64)))
    for _ in range(4):
        g, w = next(ours), next(theirs)
        assert g.keys() == w.keys() == {"tokens", "loss_mask"}
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


# ------------------------------------------------------------ optimizer
def _one_shot_update(params, grads, mu, nu, step, lr, tc, ok):
    """The update written leaf-at-a-time with no chunks, and the clip out of
    place: the formulas ``adamw`` chunks."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
    scale = torch.clamp(1.0 / torch.clamp(gn, min=1e-9), max=1.0)
    grads = [(g.float() * scale).to(g.dtype) for g in grads]
    s = step + 1
    c1, c2 = 1.0 - tc.beta1 ** s.float(), 1.0 - tc.beta2 ** s.float()
    out = []
    for p, g, m, n in zip(params, grads, mu, nu):
        gf = g.float()
        m_new = tc.beta1 * m.float() + (1 - tc.beta1) * gf
        n_new = tc.beta2 * n.float() + (1 - tc.beta2) * gf * gf
        delta = (m_new / c1) / (torch.sqrt(n_new / c2) + tc.eps)
        if p.dim() >= 2:
            delta = delta + tc.weight_decay * p.float()
        p_new = p.float() - lr * delta
        out.append([torch.where(ok, new.to(old.dtype), old)
                    for old, new in ((p, p_new), (m, m_new), (n, n_new))])
    return grads, gn, out


@pytest.mark.parametrize("ok", [True, False])
def test_chunked_adamw_and_inplace_clip_are_bit_equal_to_one_shot(ok, monkeypatch):
    monkeypatch.setattr(adamw, "CHUNK", 1000)        # leaves of 1 to 6 chunks, ragged ends
    rng = np.random.default_rng(7)
    shapes = [(47, 113), (5311,), (3, 1000), (7,)]
    params = {f"p{i}": torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for i, s in enumerate(shapes)}
    leaves = tree_leaves(params)
    grads = [torch.from_numpy(3 * rng.standard_normal(p.shape).astype(np.float32)) for p in leaves]
    state = adamw.init_state(params, torch.bfloat16)
    for t in tree_leaves(state.mu) + tree_leaves(state.nu):
        t.copy_(torch.from_numpy(np.abs(rng.standard_normal(t.shape)).astype(np.float32)))
    tc = TrainConfig(weight_decay=0.1)
    lr, okt = torch.tensor(1e-2), torch.tensor(ok)
    want_g, want_gn, want = _one_shot_update(
        leaves, grads, tree_leaves(state.mu), tree_leaves(state.nu), state.step, lr, tc, okt)
    ids = [id(g) for g in grads]
    got_g, gn = adamw.clip_by_global_norm(grads, 1.0)
    assert [id(g) for g in got_g] == ids and torch.equal(gn, want_gn)   # scaled in place
    for g, w in zip(got_g, want_g):
        assert torch.equal(g, w)
    new = adamw.apply_updates(params, got_g, state, lr, tc, ok=okt)
    assert int(new.step) == (1 if ok else 0)
    for p, m, n, (wp, wm, wn) in zip(leaves, tree_leaves(new.mu), tree_leaves(new.nu), want):
        assert torch.equal(p, wp) and torch.equal(m, wm) and torch.equal(n, wn)


def test_inplace_clip_copies_a_shared_or_strided_gradient_first():
    g = torch.full((4, 3), 2.0)
    grads, gn = adamw.clip_by_global_norm([g, g, torch.ones(3, 4).T], 1.0)
    assert gn.item() == pytest.approx(np.sqrt(2 * 12 * 4 + 12))
    scale = 1.0 / gn
    assert torch.equal(grads[0], torch.full((4, 3), 2.0) * scale)
    assert torch.equal(grads[1], grads[0]) and grads[1].data_ptr() != grads[0].data_ptr()
    assert torch.equal(grads[2], torch.ones(4, 3) * scale)


# ------------------------------------------------------------ trainer
def test_trainer_reports_router_metrics_and_takes_bf16_moments(tmp_path):
    jcfg = _jcfg(SCOUT)
    model = Model(ModelConfig(**dataclasses.asdict(jcfg)), from_jax_params(_tree(jcfg)))
    ds, tok = dataset.build_synthetic_protein_memmap(str(tmp_path / "p"), n=64, seed=0)
    tc = TrainConfig(global_batch=4, seq_len=32, total_steps=3, log_every=1, warmup_steps=1,
                     decay_steps=1)
    reg = MetricsRegistry()
    tr = loop.Trainer(model, tc, pc=ParallelConfig(optimizer_state_dtype="bfloat16"),
                      verbose=False, metrics=reg)
    state, hist = tr.run(pipeline.CLMBatches(ds, 4, 32, seed=0, eos_id=tok.eos_id))
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    # scalar history rows carry the router scalars, never the load vector
    assert {"aux_loss", "router_entropy", "router_drop_frac"} <= hist[-1].keys()
    assert "router_load" not in hist[-1]
    for name in ("train_aux_loss", "train_router_entropy", "train_router_drop_frac"):
        assert np.isfinite(reg.get(name).value), name
    loads = reg.get("train_router_load").children
    assert set(loads) == {(str(e),) for e in range(jcfg.num_experts)}
    assert sum(c.value for c in loads.values()) == pytest.approx(1.0, abs=1e-5)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(state.opt.nu))
    # the functional wrapper passes the optimizer's state dtype on
    state2, _ = loop.run_training(model, dataclasses.replace(tc, total_steps=1),
                                  pipeline.CLMBatches(ds, 4, 32, seed=0),
                                  pc=ParallelConfig(optimizer_state_dtype="bfloat16"),
                                  verbose=False)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(state2.opt.mu))
