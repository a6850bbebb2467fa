"""The port's MoE path against the reference on the CPU, on bridged weights
of reduced Llama-4 Scout (an MoE layer in every unit of one layer) and
reduced Llama-4 Maverick (units of a dense and an MoE layer): ``moe_apply``
and its whole aux vector at generous and tight capacity in fp32 and bf16;
the period-2 stack's prefill and decode steps; ``LLM.generate`` token for
token with idle slots taking decode capacity; one host transfer per steady
decode step; and a paged run with prefix caching and chunks through both
layers of the unit."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.core.config import reduced as jax_reduced  # noqa: E402
from repro.core.module import materialize as jax_materialize  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.models.transformer import decoder_stack as jax_decoder_stack  # noqa: E402
from repro.parallel.sharding import null_ctx  # noqa: E402
from repro.serving.api import LLM as JaxLLM  # noqa: E402
from repro.serving.sampling import SamplingParams as JaxSP  # noqa: E402
from repro_torch.checkpoint.bridge import from_jax_params, to_jax_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.config import ModelConfig  # noqa: E402
from repro_torch.core.module import tree_leaves  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.layers import mlp_apply  # noqa: E402
from repro_torch.models.model import Model, build_model, param_defs  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving.api import LLM  # noqa: E402
from repro_torch.serving.sampling import SamplingParams  # noqa: E402

SCOUT, MAVERICK = "llama4-scout-17b-a16e", "llama4-maverick-400b-a17b"


def _jcfg(name, **over):
    return jax_reduced(jax_configs.get_config(name), **over)


def _cfg(jcfg):
    return ModelConfig(**dataclasses.asdict(jcfg))


def _tree(jcfg, seed=0):
    """Reference init with the unit norm scales perturbed, so every scale
    matters."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(seed)))
    return jax.tree.map(
        lambda a: a + (0.1 * rng.standard_normal(a.shape)).astype(a.dtype) if a.ndim <= 2 else a,
        tree)


_PAIRS = {}


def _pair(name):
    """(reference model, its param tree, the port's model on the same
    weights) of reduced ``name``, built once per module."""
    if name not in _PAIRS:
        jcfg = _jcfg(name)
        tree = _tree(jcfg)
        _PAIRS[name] = (jax_build_model(jcfg), tree, Model(_cfg(jcfg), from_jax_params(tree)))
    return _PAIRS[name]


def _same(got, want):
    """Identical tokens and finish reasons; logprobs at 1e-4 (fp32 logits
    of the same products summed in another order)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.tokens == w.tokens, (g.index, g.tokens, w.tokens)
        assert g.finish_reason == w.finish_reason
        assert (g.logprobs is None) == (w.logprobs is None)
        if w.logprobs is not None:
            np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-4, rtol=0)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------------ config and weights
def test_moe_configs_match_reference_and_the_unit_structure():
    for name in (SCOUT, MAVERICK):
        cfg, jcfg = get_config(name), jax_configs.get_config(name)
        assert cfg == _cfg(jcfg)
        assert (cfg.param_count(), cfg.active_param_count()) == \
            (jcfg.param_count(), jcfg.active_param_count())
        assert [cfg.is_moe_layer(i) for i in range(4)] == [jcfg.is_moe_layer(i) for i in range(4)]
    scout, mav = get_config(SCOUT), get_config(MAVERICK)
    assert (T.unit_size(scout), T.num_units(scout), T.num_moe_layers(scout)) == (1, 48, 48)
    assert (T.unit_size(mav), T.num_units(mav), T.num_moe_layers(mav)) == (2, 24, 24)
    # the chip run's cut: full width, 8 of 48 layers, 39.4 GB of bf16 weights
    cut = dataclasses.replace(scout, num_layers=8)
    assert 39.3e9 < 2 * cut.param_count() < 39.5e9
    T.check_supported(scout)
    with pytest.raises(ValueError, match="whole number of units"):
        T.num_units(dataclasses.replace(mav, num_layers=7))


def test_bridge_crosses_the_expert_leaves_unchanged():
    """The 4-D expert leaves (units, E, K, N) cross bit for bit both ways
    and have the port's own shapes."""
    jcfg = _jcfg(MAVERICK)
    tree = _tree(jcfg)
    port = from_jax_params(tree)
    w_in = port["layers"]["sub1"]["ffn"]["w_in"]
    assert tuple(w_in.shape) == (1, 4, 256, 512)
    np.testing.assert_array_equal(w_in.numpy(), tree["layers"]["sub1"]["ffn"]["w_in"])
    assert [p.shape for p in tree_leaves(param_defs(_cfg(jcfg)))] == \
        [tuple(x.shape) for x in tree_leaves(port)]
    back = to_jax_params(port)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)))
    bf = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), tree)
    again = to_jax_params(from_jax_params(bf), jnp.dtype(jnp.bfloat16))
    assert all(np.array_equal(a.view(np.uint16), b.view(np.uint16))
               for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(bf)))


# ------------------------------------------------------------------ moe_apply
def _bf16_close(got, want):
    """Within two bf16 steps at each row's largest |value|.  Both sides
    round the expert products, the activation, the combine and the shared
    expert to bf16, but the reference's bf16 sigmoid rounds differently
    from torch's (up to 2^-8 apart on values below 1), so the activations
    differ by a step in places and the expert outputs carry that on."""
    top = np.abs(want).max(axis=-1, keepdims=True)
    step = 2.0 ** (np.floor(np.log2(top)) - 7)
    assert (np.abs(got - want) <= 2 * step).all(), (np.abs(got - want) / step).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity_factor", [8.0, 0.5])
@pytest.mark.parametrize("name", [SCOUT, MAVERICK])
def test_moe_apply_and_aux_match_reference(name, capacity_factor, dtype):
    """Output and the whole aux vector (router losses, dropped and total
    slots, per-expert load); at 0.5 the capacity (8 slots per expert for
    48 tokens over 4 experts) drops slots, at 8.0 it drops none."""
    jcfg = _jcfg(name, capacity_factor=capacity_factor, num_experts_per_tok=1)
    cfg = _cfg(jcfg)
    jparams = jax.tree.map(np.asarray, jax_materialize(jax_moe.moe_defs(jcfg),
                                                      jax.random.PRNGKey(3), jnp.float32))
    params = from_jax_params(jparams)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 16, jcfg.d_model)).astype(np.float32)
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    got, aux = moe.moe_apply(cfg, params, torch.from_numpy(x).to(tdt))
    want, jaux = jax_moe.moe_apply(jcfg, null_ctx(), jparams, jnp.asarray(x, jdt))
    assert got.dtype == tdt and aux.dtype == torch.float32 and aux.shape == moe.aux_shape(cfg)
    np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), atol=1e-5, rtol=0)
    dropped = float(aux[2])
    assert (dropped > 0) == (capacity_factor < 1)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    else:
        _bf16_close(got.float().numpy(), _np(want))
    if capacity_factor > 1 and dtype == "float32":
        # no drops: the ragged path equals the dense no-capacity oracle plus
        # the shared expert, and the oracle is the reference's
        xt = torch.from_numpy(x)
        dense = moe.moe_ref_dense(cfg, params, xt)
        np.testing.assert_allclose(dense.numpy(), np.asarray(jax_moe.moe_ref_dense(
            jcfg, jparams, jnp.asarray(x))), atol=1e-5, rtol=0)
        shared = mlp_apply(cfg, params["shared"], xt)
        np.testing.assert_allclose(got.numpy(), (dense + shared).numpy(), atol=1e-5, rtol=0)


def test_routing_ties_go_to_the_lower_expert_and_earlier_tokens_win_capacity():
    """Equal router probabilities pick the lower expert index (jax's top_k
    order); with more tokens on one expert than the capacity, the earliest
    tokens keep their slots and the later ones carry only the shared
    expert: idle decode slots ahead of a live one take its capacity."""
    jcfg = _jcfg(SCOUT, num_experts_per_tok=1)
    cfg = _cfg(jcfg)
    jparams = jax.tree.map(np.array, jax_materialize(jax_moe.moe_defs(jcfg),
                                                     jax.random.PRNGKey(5), jnp.float32))
    rng = np.random.default_rng(9)
    v = jparams["router"][:, 0] + 0.05
    jparams["router"][:, 1] = jparams["router"][:, 2] = v      # experts 1 and 2 tie, on top
    params = from_jax_params(jparams)
    # 12 decode slots (B=12, S=1), capacity 8: ten identical rows ("idle
    # slots") ahead of two live ones, all leaning on the tied experts
    rows = 3.0 * v / np.linalg.norm(v) + 0.1 * rng.standard_normal((3, jcfg.d_model))
    x = np.concatenate([np.repeat(rows[:1], 10, 0), rows[1:]]).astype(np.float32)[:, None, :]
    probs, _, idx = moe._route(cfg, params, torch.from_numpy(x[:, 0]))
    _, _, jidx = jax_moe._route(jcfg, jparams, jnp.asarray(x[:, 0]))
    assert torch.equal(probs[:, 1], probs[:, 2]) and (idx[:, 0] == 1).all()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    got, aux = moe.moe_apply(cfg, params, torch.from_numpy(x))
    want, jaux = jax_moe.moe_apply(jcfg, null_ctx(), jparams, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), atol=1e-5, rtol=0)
    assert moe.capacity(cfg, 12) == 8 and float(aux[2]) == 4
    shared = mlp_apply(cfg, params["shared"], torch.from_numpy(x))
    assert torch.equal(got[8:], shared[8:])          # rows 8-11: over capacity
    assert not (got[:8] == shared[:8]).all(dim=-1).any()


# ------------------------------------------------------------------ the period-2 stack
@pytest.mark.parametrize("per_slot", [False, True])
def test_period2_stack_prefill_and_decode_match_reference(per_slot):
    jm, tree, model = _pair(MAVERICK)
    params = model.params.tree()
    assert sorted(params["layers"]) == ["sub0", "sub1"]
    assert "router" in params["layers"]["sub1"]["ffn"] and "router" not in params["layers"]["sub0"]["ffn"]
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 500, size=(3, 70)).astype(np.int32)     # past the window of 64
    max_len = 96
    lg, cache = model.prefill(params, {"tokens": torch.from_numpy(toks)}, max_len)
    jlg, jcache = jax.jit(jm.prefill, static_argnums=(2,))(tree, {"tokens": jnp.asarray(toks)},
                                                            max_len)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4, rtol=0)

    def check_cache():
        g, w = tree_leaves(cache["layers"]), jax.tree.leaves(jcache["layers"])
        assert len(g) == len(w) == 4           # k and v of both layers of the unit
        for a, b in zip(g, w):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)

    check_cache()
    if per_slot:
        pos = np.array([70, 41, 9], np.int32)
        cache["pos"], jcache["pos"] = torch.from_numpy(pos.copy()), jnp.asarray(pos)
    jdecode = jax.jit(jm.decode_step)
    for t in range(4):
        nxt = rng.integers(0, 500, size=(3, 1)).astype(np.int32)
        lg, cache = model.decode_step(params, cache, torch.from_numpy(nxt))
        jlg, jcache = jdecode(tree, jcache, jnp.asarray(nxt))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4, rtol=0,
                                   err_msg=f"step {t}")
        check_cache()


def test_stack_sums_the_aux_vectors_and_the_loss_waits_for_moe_training():
    _, tree, model = _pair(MAVERICK)
    params = model.params.tree()
    toks = np.random.default_rng(2).integers(0, 500, size=(2, 12)).astype(np.int32)
    x = model._decoder_input(params, torch.from_numpy(toks))
    _, _, aux = T.decoder_stack(model.cfg, params["layers"], x)
    aux = aux.detach()
    _, _, jaux = jax_decoder_stack(_jcfg(MAVERICK), null_ctx(), tree["layers"],
                                   jnp.asarray(x.detach().numpy()))
    np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), atol=1e-5, rtol=0)
    assert aux.shape == (moe.AUX_BASE + 4,) and float(aux[3]) == 24.0    # one MoE layer, 24 slots
    # the loss now carries the router terms and metrics, as the reference's
    jm, _, _ = _pair(MAVERICK)
    loss, m = model.loss_fn(params, {"tokens": torch.from_numpy(toks)})
    jloss, jmet = jm.loss_fn(tree, {"tokens": jnp.asarray(toks)})
    assert abs(loss.item() - float(jloss)) <= 1e-5
    for k in ("ce_loss", "aux_loss", "router_entropy", "router_drop_frac", "router_load"):
        np.testing.assert_allclose(m[k].detach().numpy(), np.asarray(jmet[k]), atol=1e-5, rtol=0,
                                   err_msg=k)
    assert loss.item() == pytest.approx(
        m["ce_loss"].item() + model.cfg.router_aux_coef * float(aux[0])
        + model.cfg.router_entropy_coef * float(aux[1]), abs=1e-6)


# ------------------------------------------------------------------ LLM.generate
def _prompts(n, lengths=(9, 70), seed=0, vocab=500):
    """Prompts of a few lengths (one past the reduced window of 64): a
    windowed model prefills at exact lengths, and the reference compiles
    each length once."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(L)).tolist() for L in rng.choice(lengths, size=n)]


def _mix(SP, n):
    """Short greedy and seeded requests, then one long seeded request that
    decodes alone in a late slot while the earlier slots sit idle."""
    base = [SP(max_new=2), SP(temperature=0.8, top_k=20, top_p=0.9, seed=3, max_new=3,
                              logprobs=True), SP(max_new=2, logprobs=True)]
    return (base * n)[:n - 1] + [SP(temperature=1.1, seed=2**31 + 5, max_new=14)]


@pytest.mark.parametrize("name", [SCOUT, MAVERICK])
def test_generate_matches_reference_with_idle_slots_taking_capacity(name, monkeypatch):
    """12 slots, 10 requests: after the short ones finish, nine idle slots
    (token 0 at position 0, one expert for all of them) sit ahead of the
    long request in the decode batch and, with the two idle slots behind
    it, overflow the capacity of 8 — the port drops the same slots as the
    reference, token for token, greedy and seeded."""
    jm, tree, model = _pair(name)
    prompts = _prompts(10, seed=1)
    seen = []
    apply = moe.moe_apply

    def spy(cfg, params, x, ctx=None):
        out, aux = apply(cfg, params, x, ctx)
        if x.shape[1] == 1:
            seen.append(float(aux[2]))
        return out, aux

    monkeypatch.setattr(moe, "moe_apply", spy)
    got = LLM(model, slots=12, max_len=128).generate(prompts, _mix(SamplingParams, 10))
    monkeypatch.undo()
    want = JaxLLM(jm, tree, slots=12, max_len=128).generate(prompts, _mix(JaxSP, 10))
    _same(got, want)
    assert [len(c.tokens) for c in got] == [2, 3, 2] * 3 + [14]
    assert max(seen) >= 3          # the idle slots overflow the decode capacity


def test_steady_moe_decode_step_makes_one_host_transfer(monkeypatch):
    """The MoE layer reads nothing on the host: a steady step copies the
    sampled triple once, through ``to_host``, and no tensor otherwise."""
    _, _, model = _pair(SCOUT)
    eng = LLM(model, slots=3, max_len=64).engine
    for i, p in enumerate(_prompts(3, lengths=(12, 20), seed=13)):
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


def test_paged_period2_prefix_cache_and_chunks_match_reference():
    """reduced(maverick) without its window, over the paged cache with
    prefix caching and 5-token chunks: the engine inserts, copies and reads
    the pools of both layers of the unit, token for token with the
    reference, cold and warm."""
    jcfg = _jcfg(MAVERICK, sliding_window=0)
    tree = _tree(jcfg, seed=2)
    jm, model = jax_build_model(jcfg), Model(_cfg(jcfg), from_jax_params(tree))
    rng = np.random.default_rng(4)
    pre = rng.integers(0, 500, size=24).tolist()
    prompts = [pre + rng.integers(0, 500, size=int(L)).tolist() if i % 2 else
               rng.integers(0, 500, size=int(L)).tolist()
               for i, L in enumerate(rng.integers(3, 20, size=6))] + [list(pre)]
    params = [SamplingParams(max_new=5),
              SamplingParams(temperature=0.8, top_k=20, seed=3, max_new=5)] * 3 + \
        [SamplingParams(max_new=4)]
    jparams = [JaxSP(**dataclasses.asdict(p)) for p in params]
    kw = dict(slots=3, max_len=64, cache_layout="paged", page_size=8, prefix_cache=True,
              prefill_chunk=5)
    llm, jllm = LLM(model, **kw), JaxLLM(jm, tree, **kw)
    for _ in range(2):                      # cold, then warm on the registered blocks
        _same(llm.generate(prompts, params), jllm.generate(prompts, jparams))
        assert llm.engine.alloc.stats == jllm.engine.alloc.stats
    assert llm.engine.alloc.stats["hit_tokens"] > 0 and llm.engine.alloc.stats["cow_copies"] >= 1
    pools = llm.engine.cache["layers"]
    assert sorted(pools) == ["sub0", "sub1"]
    assert not torch.equal(pools["sub0"]["attn"]["k_pool"], pools["sub1"]["attn"]["k_pool"])
    llm.engine.alloc.check_invariants()


def test_bf16_scout_generates_on_the_cpu():
    small = dataclasses.replace(_cfg(_jcfg(SCOUT)), param_dtype="bfloat16", dtype="bfloat16")
    model = build_model(small, device="cpu")
    assert model.params.layers.sub0.ffn.w_in.dtype == torch.bfloat16
    out = LLM(model, slots=2, max_len=32).generate(_prompts(2, lengths=(5, 11), seed=2),
                                                  SamplingParams(max_new=4))
    assert [len(c.tokens) for c in out] == [4, 4]
