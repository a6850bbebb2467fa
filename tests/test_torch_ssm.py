"""The port's SSM path against the reference on the CPU, on bridged weights
of reduced Mamba2-2.7B (two SSD layers) and reduced Jamba-1.5-Large (one
unit of eight layers: seven SSD layers and one attention layer, MoE top-2
on every other layer): ``ssm_apply`` in train, prefill and decode modes in
fp32 and bf16, the configs and their parameter counts, the SSM leaves
through the bridge, the seeded init of A and dt_bias, ``LLM.generate``
token for token with idle slots, one host transfer per steady decode
step, a prefill continued by a decode step against the longer prefill,
the loss and every gradient leaf, five train steps, and the layouts the
engine refuses."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.core.config import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.core.config import reduced as jax_reduced  # noqa: E402
from repro.core.module import materialize as jax_materialize  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.parallel.sharding import null_ctx  # noqa: E402
from repro.serving.api import LLM as JaxLLM  # noqa: E402
from repro.serving.sampling import SamplingParams as JaxSP  # noqa: E402
from repro.training import train_step as jax_ts  # noqa: E402
from repro_torch.checkpoint.bridge import from_jax_params, to_jax_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.config import ModelConfig, TrainConfig  # noqa: E402
from repro_torch.core.module import tree_leaves  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.model import Model, build_model, param_defs  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving.api import LLM  # noqa: E402
from repro_torch.serving.sampling import SamplingParams  # noqa: E402
from repro_torch.training.train_step import init_train_state, make_train_step  # noqa: E402

MAMBA2, JAMBA = "mamba2-2.7b", "jamba-1.5-large-398b"


def _jcfg(name, **over):
    return jax_reduced(jax_configs.get_config(name), **over)


def _cfg(jcfg):
    return ModelConfig(**dataclasses.asdict(jcfg))


def _perturbed(tree, seed):
    """The reference's init with every vector leaf (norm scales, conv bias,
    A, D, dt_bias) moved by 0.1 noise, so each one matters; A stays below
    -0.5."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: a + (0.1 * rng.standard_normal(a.shape)).astype(a.dtype) if a.ndim <= 2 else a,
        tree)


_PAIRS = {}


def _pair(name):
    """(reference model, its param tree, the port's model on the same
    weights) of reduced ``name``, built once per module."""
    if name not in _PAIRS:
        jcfg = _jcfg(name)
        jm = jax_build_model(jcfg)
        tree = _perturbed(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))), 0)
        _PAIRS[name] = (jm, tree, Model(_cfg(jcfg), from_jax_params(tree)))
    return _PAIRS[name]


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------------ configs and weights
def test_ssm_configs_and_param_counts_match_reference():
    for name, count in ((MAMBA2, 2_701_081_600), (JAMBA, 397_705_657_600)):
        cfg, jcfg = get_config(name), jax_configs.get_config(name)
        assert cfg == _cfg(jcfg)
        assert cfg.param_count() == jcfg.param_count() == count
        assert (cfg.d_inner, cfg.ssm_nheads) == (jcfg.d_inner, jcfg.ssm_nheads)
        T.check_supported(cfg)
        small = _jcfg(name)
        assert _cfg(small).param_count() == small.param_count()
    mamba, jamba = get_config(MAMBA2), get_config(JAMBA)
    assert (mamba.d_inner, mamba.ssm_nheads, T.unit_size(mamba), T.num_units(mamba)) == \
        (5120, 80, 1, 64)
    assert (T.unit_size(jamba), T.num_units(jamba), T.num_moe_layers(jamba)) == (8, 9, 36)
    assert [jamba.is_attn_layer(i) for i in range(8)] == [i == 4 for i in range(8)]


@pytest.mark.parametrize("name", [MAMBA2, JAMBA])
def test_bridge_crosses_the_ssm_leaves_bit_for_bit(name):
    _, tree, model = _pair(name)
    port = from_jax_params(tree)
    sub = next(s for s in sorted(port["layers"]) if "ssm" in port["layers"][s])
    assert sorted(port["layers"][sub]["ssm"]) == ["A", "D", "conv_b", "conv_w", "dt_bias",
                                                   "norm_scale", "w_in", "w_out"]
    assert [p.shape for p in tree_leaves(param_defs(model.cfg))] == \
        [tuple(x.shape) for x in tree_leaves(port)]
    back = to_jax_params(port)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)))
    bf = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), tree)
    again = to_jax_params(from_jax_params(bf), jnp.dtype(jnp.bfloat16))
    assert all(np.array_equal(a.view(np.uint16), b.view(np.uint16))
               for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(bf)))


def test_seeded_init_draws_a_and_dt_bias_in_the_reference_ranges():
    """A = -U[1, 16) for every head (a fan-in draw would give some A > 0
    and an exploding state) and softplus(dt_bias) in [1e-3, 1e-1]; the same
    seed gives the same weights."""
    cfg = dataclasses.replace(_cfg(_jcfg(MAMBA2)), ssm_headdim=8)     # 64 heads a layer
    p = build_model(cfg, device="cpu", seed=3).params.tree()["layers"]["sub0"]["ssm"]
    A, dtb = p["A"].detach(), p["dt_bias"].detach()
    assert A.shape == (2, 64) and bool(((A >= -16) & (A < -1)).all()) and A.std() > 2
    dt = torch.nn.functional.softplus(dtb)
    assert bool(((dt >= 1e-3 * 0.999) & (dt <= 0.1 * 1.001)).all())
    assert torch.equal(build_model(cfg, device="cpu", seed=3).params.tree()["layers"]["sub0"]
                       ["ssm"]["A"], p["A"])


# ------------------------------------------------------------------ ssm_apply
def _ssm_case(dtype, seed=3):
    jcfg = _jcfg(MAMBA2, dtype=dtype)
    jparams = _perturbed(jax.tree.map(np.asarray, jax_materialize(
        jax_ssm.ssm_defs(jcfg), jax.random.PRNGKey(seed), jnp.float32)), seed)
    return jcfg, _cfg(jcfg), jparams, from_jax_params(jparams)


def _bf16_close(got, want, steps):
    """Within ``steps`` bf16 steps of each row's largest |value|."""
    top = np.abs(want).max(axis=-1, keepdims=True)
    step = 2.0 ** (np.floor(np.log2(top)) - 7)
    assert (np.abs(got - want) <= steps * step).all(), (np.abs(got - want) / step).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_apply_matches_reference_in_every_mode(dtype):
    """Train and prefill over 21 rows (not a multiple of the chunk of 8),
    the prefill's conv buffer and state, then three decode steps from
    them, each advancing the cache in place.  fp32 at 1e-4.  bf16 against
    the reference's XLA path, which stores the (L × L) decay weights in
    bf16 where the port's scan keeps them in fp32, and both round the
    projections, the conv and y to bf16: the outputs and conv buffers
    within 2 bf16 steps of each row's max (measured: 1), the state, fp32
    on both sides, at 1e-4 (measured: 8e-7)."""
    jcfg, cfg, jparams, params = _ssm_case(dtype)
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 21, jcfg.d_model)).astype(np.float32)
    ctx = null_ctx()

    def close(got, want):
        if dtype == "float32":
            np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=0)
        else:
            _bf16_close(_np(got), _np(want), 2)

    out, none = ssm.ssm_apply(cfg, params, torch.from_numpy(x).to(tdt), mode="train")
    want, _ = jax_ssm.ssm_apply(jcfg, ctx, jparams, jnp.asarray(x, jdt), mode="train")
    assert none is None and out.dtype == tdt
    close(out, want)
    out, cache = ssm.ssm_apply(cfg, params, torch.from_numpy(x).to(tdt), mode="prefill")
    want, jcache = jax_ssm.ssm_apply(jcfg, ctx, jparams, jnp.asarray(x, jdt), mode="prefill")
    close(out, want)
    assert cache["conv"].dtype == tdt and cache["state"].dtype == torch.float32
    close(cache["conv"], jcache["conv"])
    np.testing.assert_allclose(_np(cache["state"]), _np(jcache["state"]), atol=1e-4, rtol=0)
    conv, state = cache["conv"], cache["state"]
    for t in range(3):
        xt = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        out, same = ssm.ssm_apply(cfg, params, torch.from_numpy(xt).to(tdt), mode="decode",
                                  cache=cache)
        want, jcache = jax_ssm.ssm_apply(jcfg, ctx, jparams, jnp.asarray(xt, jdt), mode="decode",
                                         cache=jcache)
        assert same is cache and cache["conv"] is conv and cache["state"] is state
        close(out, want)
        close(conv, jcache["conv"])
        np.testing.assert_allclose(_np(state), _np(jcache["state"]), atol=1e-4, rtol=0)


def test_short_prompt_zero_pads_the_conv_buffer():
    jcfg, cfg, jparams, params = _ssm_case("float32")
    x = np.random.default_rng(2).standard_normal((1, 2, jcfg.d_model)).astype(np.float32)
    _, cache = ssm.ssm_apply(cfg, params, torch.from_numpy(x), mode="prefill")
    _, jcache = jax_ssm.ssm_apply(jcfg, null_ctx(), jparams, jnp.asarray(x), mode="prefill")
    assert cache["conv"].shape == (1, jcfg.ssm_conv - 1, ssm._dims(cfg)[4])
    assert not cache["conv"][:, 0].any()
    np.testing.assert_allclose(cache["conv"].numpy(), _np(jcache["conv"]), atol=1e-5, rtol=0)


# ------------------------------------------------------------------ the stack and the engine
@pytest.mark.parametrize("name", [MAMBA2, JAMBA])
def test_prefill_then_decode_equals_the_longer_prefill(name):
    """An exact-length prefill of S tokens and one decode step of token S
    give the logits and the SSM state of a prefill of S + 1 tokens; the
    engine's cache holds the prefill's conv and state unpadded."""
    _, _, m = _pair(name)
    # capacity for every routed slot, so that the two prefills' MoE drops
    # (capacity grows with the rows) cannot differ
    model = Model(dataclasses.replace(m.cfg, capacity_factor=8.0), m.params.tree())
    params = model.params.tree()
    toks = np.random.default_rng(8).integers(0, 500, size=(1, 14)).astype(np.int32)
    toks = torch.from_numpy(toks)
    _, cache = model.prefill(params, {"tokens": toks[:, :13]}, 32)
    lg2, cache = model.decode_step(params, cache, toks[:, 13:])
    want, wcache = model.prefill(params, {"tokens": toks}, 32)
    np.testing.assert_allclose(lg2.numpy(), want.numpy(), atol=1e-4, rtol=0)
    for sub, leaves in wcache["layers"].items():
        if "ssm" in leaves:
            assert leaves["ssm"]["state"].shape[1:] == (1, *ssm._dims(model.cfg)[1:2], 32, 16)
            for n in ("conv", "state"):
                np.testing.assert_allclose(cache["layers"][sub]["ssm"][n].numpy(),
                                           leaves["ssm"][n].numpy(), atol=1e-4, rtol=0)
        else:
            assert leaves["attn"]["k"].shape[2] == 32          # K/V padded to max_len


def _prompts(n, seed=0, lengths=(5, 13)):
    """Prompts of two lengths: SSM prompts prefill at their exact length,
    and the reference compiles each length once."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 500, size=int(L)).tolist() for L in rng.choice(lengths, size=n)]


def _mix(SP, n):
    """Short greedy and seeded requests, then one long seeded request that
    decodes alone while the other slots sit idle."""
    base = [SP(max_new=2), SP(temperature=0.8, top_k=20, top_p=0.9, seed=3, max_new=3,
                              logprobs=True), SP(max_new=2, logprobs=True)]
    return (base * n)[:n - 1] + [SP(temperature=1.1, seed=2**31 + 5, max_new=9)]


@pytest.mark.parametrize("name", [MAMBA2, JAMBA])
def test_generate_matches_reference_with_idle_slots(name):
    """3 slots, 6 requests, token for token (greedy and seeded, logprobs at
    1e-4): idle slots step their SSM state in lockstep and a new request's
    admission overwrites its slot's conv buffer and state."""
    jm, tree, model = _pair(name)
    prompts = _prompts(6, seed=1)
    got = LLM(model, slots=3, max_len=48).generate(prompts, _mix(SamplingParams, 6))
    want = JaxLLM(jm, tree, slots=3, max_len=48).generate(prompts, _mix(JaxSP, 6))
    for g, w in zip(got, want):
        assert g.tokens == w.tokens and g.finish_reason == w.finish_reason
        if w.logprobs is not None:
            np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-4, rtol=0)
    assert [len(c.tokens) for c in got] == [2, 3, 2, 2, 3, 9]


def test_steady_ssm_decode_step_makes_one_host_transfer(monkeypatch):
    """The SSM decode step reads nothing on the host: a steady step copies
    the sampled triple once, through ``to_host``, and no tensor otherwise."""
    _, _, model = _pair(JAMBA)
    eng = LLM(model, slots=3, max_len=64).engine
    for i, p in enumerate(_prompts(3, seed=13, lengths=(12, 20))):
        eng.submit(engine_mod.Request(uid=i, prompt=np.asarray(p, np.int32),
                                      params=SamplingParams(temperature=0.7, seed=i, max_new=20)))
    eng.step()
    eng.step()

    def banned(*a, **k):
        raise AssertionError("host read of a tensor inside the decode step")

    for name in ("item", "tolist", "__bool__", "__int__", "__float__", "__index__", "nonzero"):
        monkeypatch.setattr(torch.Tensor, name, banned)
    before = engine_mod.to_host.transfers
    for _ in range(3):
        assert eng.step() == 3
    monkeypatch.undo()
    assert engine_mod.to_host.transfers - before == 3


def test_engine_refuses_the_paged_layout_and_pads_no_ssm_prompt():
    _, _, model = _pair(MAMBA2)
    for kw in (dict(cache_layout="paged"), dict(cache_layout="paged", prefix_cache=True),
               dict(prefill_chunk=4)):
        with pytest.raises(ValueError, match="SSM layers"):
            LLM(model, slots=2, max_len=64, **kw)
    eng = LLM(model, slots=2, max_len=64).engine
    assert not eng.bucket_prompts and eng._bucket(13) == 13
    with pytest.raises(ValueError, match="attention-only"):
        T.decoder_stack(model.cfg, model.params.tree()["layers"],
                        torch.zeros(1, 4, model.cfg.d_model), mode="chunk",
                        caches={"sub0": {"ssm": {}}})


def _loss_and_every_grad_leaf_match_reference(name):
    """``loss_fn`` and the gradient of every leaf on bridged weights against
    the reference's ``loss_fn`` and ``jax.grad`` of it (its SSD gradient is
    XLA's autodiff of ``_ssd_chunked_xla``; the port's CPU route is
    ``SSDScan`` on its plain halves, the explicit chunked backward).  fp32
    both: the loss within 1e-5 and each leaf within 1e-4 of its largest
    magnitude (measured: 4.4e-5 for reduced Mamba2 over 11 leaves, 2.8e-5
    for reduced Jamba over 107)."""
    jm, tree, model = _pair(name)
    toks = np.random.default_rng(4).integers(0, 500, size=(2, 19)).astype(np.int32)
    params = model.params.tree()
    loss, _ = model.loss_fn(params, {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, tree_leaves(params))
    (want, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, {"tokens": jnp.asarray(toks)}), has_aux=True))(tree)
    np.testing.assert_allclose(loss.item(), float(want), atol=1e-5, rtol=0)
    want_leaves = jax.tree.leaves(jgrads)
    assert len(grads) == len(want_leaves)
    for path, g, w in zip(_leaf_paths(params), grads, want_leaves):
        w = np.asarray(w)
        assert g.shape == w.shape and torch.isfinite(g).all(), path
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * np.abs(w).max(), rtol=0,
                                   err_msg=path)


def _leaf_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _leaf_paths(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def test_ssm_loss_matches_reference_and_trains_through_the_plain_scan():
    _loss_and_every_grad_leaf_match_reference(MAMBA2)


def test_hybrid_loss_and_every_grad_leaf_match_reference():
    _loss_and_every_grad_leaf_match_reference(JAMBA)


def test_five_mamba2_train_steps_match_reference():
    """5 AdamW steps (fp32 moments, accum 2, warmup then cosine decay) of
    reduced Mamba2 from bridged weights against the reference's train step
    on the same batches: loss and grad norm at every step, then every
    parameter and moment (fp32; Adam moves a near-zero-gradient weight by up
    to ~lr when the grads differ in their last bits)."""
    jm, tree, _ = _pair(MAMBA2)
    kw = dict(global_batch=4, seq_len=24, learning_rate=1e-3, warmup_steps=2, decay_steps=2,
              total_steps=5, weight_decay=0.1, accum_steps=2)
    jstep = jax.jit(jax_ts.make_train_step(jm, JaxTrainConfig(**kw)))
    jstate = jax_ts.TrainState(tree, jax_adamw.init_state(tree))
    model = Model(_cfg(_jcfg(MAMBA2)), from_jax_params(tree))
    state, step = init_train_state(model), make_train_step(model, TrainConfig(**kw))
    rng = np.random.default_rng(8)
    for _ in range(5):
        toks = rng.integers(0, 500, size=(4, 24)).astype(np.int32)
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(toks)})
        state, m = step(state, {"tokens": torch.from_numpy(toks)})
        assert abs(m["loss"].item() - float(jmet["loss"])) <= 1e-5
        assert abs(m["grad_norm"].item() - float(jmet["grad_norm"])) \
            <= 1e-4 * float(jmet["grad_norm"])
    assert int(state.opt.step) == int(jstate.opt.step) == 5
    got = tree_leaves(state.params) + tree_leaves(state.opt.mu) + tree_leaves(state.opt.nu)
    want = (jax.tree.leaves(jstate.params) + jax.tree.leaves(jstate.opt.mu)
            + jax.tree.leaves(jstate.opt.nu))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-4, rtol=0)
