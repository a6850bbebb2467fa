"""The port's generation path against the reference on reduced(qwen2-7b,
num_kv_heads=2) in fp32 with bridged weights: ``prefill`` and
``decode_step`` (lockstep and per-slot positions, a rolling sliding-window
cache), and ``LLM.generate`` / ``LLM.stream`` token for token — greedy and
seeded sampling, stop tokens and sequences, the bounded queue, deadlines,
cancellation and NaN quarantine — plus the one host transfer per steady
decode step."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.core.config import reduced as jax_reduced  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving.api import LLM as JaxLLM  # noqa: E402
from repro.serving.faults import FaultPlan as JaxFaultPlan  # noqa: E402
from repro.serving.sampling import SamplingParams as JaxSP  # noqa: E402
from repro_torch.checkpoint.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.config import ModelConfig, ServeConfig  # noqa: E402
from repro_torch.core.module import tree_leaves  # noqa: E402
from repro_torch.models.model import Model, build_model  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.obs.trace import TraceRecorder  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving.api import LLM  # noqa: E402
from repro_torch.serving.faults import FaultPlan  # noqa: E402
from repro_torch.serving.sampling import SamplingParams  # noqa: E402


def _jcfg(**over):
    return jax_reduced(jax_configs.get_config("qwen2-7b"), num_kv_heads=2, **over)


def _tree(jcfg, seed=0):
    """Reference init with the zero biases and unit norm scales perturbed,
    so the comparison exercises every bias and scale."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(seed)))
    return jax.tree.map(
        lambda a: a + (0.1 * rng.standard_normal(a.shape)).astype(a.dtype) if a.ndim <= 2 else a,
        tree)


@pytest.fixture(scope="module")
def pair():
    """(reference model, its param tree, the port's model on the same weights)."""
    jcfg = _jcfg()
    tree = _tree(jcfg)
    return jax_build_model(jcfg), tree, Model(ModelConfig(**dataclasses.asdict(jcfg)),
                                              from_jax_params(tree))


def _prompts(n, lo=3, hi=30, seed=0, vocab=500):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(L)).tolist() for L in rng.integers(lo, hi, size=n)]


def _params_mix(SP, n):
    """Greedy, seeded top-k/top-p mixes, a seed past 2^31, logprobs."""
    base = [
        SP(max_new=8),
        SP(temperature=0.8, top_k=20, top_p=0.9, seed=3, max_new=8, logprobs=True),
        SP(temperature=1.2, top_p=0.7, seed=2**31 + 5, max_new=7, logprobs=True),
        SP(temperature=0.5, top_k=5, seed=9, max_new=9),
        SP(max_new=6, logprobs=True),
    ]
    return (base * n)[:n]


def _same(got, want):
    """Completions: identical tokens and finish reasons; logprobs at 1e-4
    (fp32 logits of the same products summed in another order)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.index == w.index
        assert g.tokens == w.tokens, (g.index, g.tokens, w.tokens)
        assert g.finish_reason == w.finish_reason, (g.index, g.finish_reason, w.finish_reason)
        assert (g.logprobs is None) == (w.logprobs is None)
        if w.logprobs is not None:
            np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-4, rtol=0)
        assert (g.ttft_s is None) == (w.ttft_s is None)
        assert (g.queue_wait_s is None) == (w.queue_wait_s is None)


# ------------------------------------------------------------------ model entry points
def _check_cache(got, want):
    """Cache leaves match the reference's (fp32 K/V from the same products
    summed in another order: 1e-5), zero padding included."""
    g, w = tree_leaves(got["layers"]), jax.tree.leaves(want["layers"])
    assert len(g) == len(w) == 2
    for a, b in zip(g, w):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(np.asarray(got["pos"]), np.asarray(want["pos"]))


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("per_slot", [False, True])
def test_prefill_and_decode_steps_match_reference(window, per_slot):
    jcfg = _jcfg(sliding_window=window)
    tree = _tree(jcfg, seed=1)
    jm = jax_build_model(jcfg)
    model = Model(ModelConfig(**dataclasses.asdict(jcfg)), from_jax_params(tree))
    params = model.params.tree()
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 500, size=(3, 13)).astype(np.int32)    # 13 > the window of 8
    max_len = 32
    jprefill = jax.jit(jm.prefill, static_argnums=(2,))
    jdecode = jax.jit(jm.decode_step)
    lg, cache = model.prefill(params, {"tokens": torch.from_numpy(toks)}, max_len)
    jlg, jcache = jprefill(tree, {"tokens": jnp.asarray(toks)}, max_len)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4, rtol=0)
    _check_cache(cache, jcache)
    if per_slot:   # rows at different positions, as the serving engine keeps them
        pos = np.array([13, 9, 4], np.int32)
        cache["pos"], jcache["pos"] = torch.from_numpy(pos.copy()), jnp.asarray(pos)
    for t in range(8):
        nxt = rng.integers(0, 500, size=(3, 1)).astype(np.int32)
        lg, cache = model.decode_step(params, cache, torch.from_numpy(nxt))
        jlg, jcache = jdecode(tree, jcache, jnp.asarray(nxt))
        assert lg.shape == (3, 1, jcfg.padded_vocab)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4, rtol=0, err_msg=f"step {t}")
        _check_cache(cache, jcache)


def test_init_cache_matches_reference_shapes(pair):
    jm, _, model = pair
    got, want = model.init_cache(3, 40), jm.init_cache(3, 40)
    assert [tuple(x.shape) for x in tree_leaves(got["layers"])] == \
        [x.shape for x in jax.tree.leaves(want["layers"])]
    assert got["pos"] == 0 and all((x == 0).all() for x in tree_leaves(got["layers"]))


# ------------------------------------------------------------------ LLM.generate / stream
def test_generate_matches_reference_greedy_and_seeded(pair):
    jm, tree, model = pair
    prompts = _prompts(7)
    jllm = JaxLLM(jm, tree, slots=3, max_len=64)
    want = jllm.generate(prompts, _params_mix(JaxSP, 7))
    llm = LLM(model, slots=3, max_len=64)
    got = llm.generate(prompts, _params_mix(SamplingParams, 7))
    _same(got, want)
    assert any(g.logprobs for g in got) and len({tuple(g.tokens) for g in got}) == 7

    # stop tokens and stop sequences taken from the run above
    stops = [SamplingParams(max_new=8, stop_token_ids=(got[0].tokens[3],)),
             SamplingParams(temperature=0.8, top_k=20, top_p=0.9, seed=3, max_new=8,
                            stop_sequences=(tuple(got[1].tokens[2:4]), (999, 998)))]
    jstops = [JaxSP(**dataclasses.asdict(s)) for s in stops]
    g2, w2 = llm.generate(prompts[:2], stops), jllm.generate(prompts[:2], jstops)
    _same(g2, w2)
    assert [g.finish_reason for g in g2] == ["stop", "stop"]
    assert g2[0].tokens == got[0].tokens[:4] and g2[1].tokens == got[1].tokens[:4]


def test_generate_is_repeatable_and_independent_of_batch_mates(pair):
    _, _, model = pair
    prompts = _prompts(5, seed=3)
    params = _params_mix(SamplingParams, 5)
    llm = LLM(model, slots=4, max_len=64)
    a = llm.generate(prompts, params)
    assert [x.tokens for x in llm.generate(prompts, params)] == [x.tokens for x in a]
    for i in (1, 2):     # the seeded requests, alone
        assert llm.generate([prompts[i]], [params[i]])[0].tokens == a[i].tokens


def test_faults_overload_deadlines_and_quarantine_match_reference(pair):
    """One engine run through the degraded paths, port and reference side
    by side: a bounded queue rejects two prompts ("overloaded"), a queued
    request times out without running, NaN logits quarantine one slot
    ("error"), an in-flight request times out keeping its tokens, and the
    rest finish normally.  The clock is the engine's step count."""
    jm, tree, model = pair
    prompts = _prompts(6, seed=7)

    def params(SP):
        ps = [SP(max_new=6) for _ in prompts]
        ps[2] = SP(max_new=6, temperature=0.9, seed=4, deadline_ms=45.0, logprobs=True)
        ps[3] = SP(max_new=6, deadline_ms=15.0)
        return ps

    def run(llm, SP):
        eng = llm.engine
        eng._clock = lambda: eng.steps * 0.01
        return llm.generate(prompts, params(SP)), eng

    trace = TraceRecorder()
    got, eng = run(LLM(model, slots=2, max_len=64, max_queue=4, faults=FaultPlan(nan={3: (1,)}),
                       trace=trace, metrics=MetricsRegistry()), SamplingParams)
    want, jeng = run(JaxLLM(jm, tree, slots=2, max_len=64, max_queue=4,
                            faults=JaxFaultPlan(nan={3: (1,)})), JaxSP)
    _same(got, want)
    assert [g.finish_reason for g in got] == \
        ["length", "error", "timeout", "timeout", "overloaded", "overloaded"]
    assert got[2].tokens and not got[3].tokens and got[3].ttft_s is None
    assert eng.health().counters == jeng.health().counters
    assert eng.health().steps == jeng.health().steps
    events = {e["event"] for e in trace.events()}
    assert {"overload_reject", "quarantine", "timeout", "finish", "decode"} <= events


def test_stream_equals_generate_and_cancel_matches_reference(pair):
    jm, tree, model = pair
    prompts = _prompts(4, seed=11)
    params = _params_mix(SamplingParams, 4)
    llm = LLM(model, slots=2, max_len=64)
    full = llm.generate(prompts, params)
    chunks = list(llm.stream(prompts, params))
    for c in full:
        mine = [x for x in chunks if x.index == c.index]
        assert [x.token for x in mine] == c.tokens
        assert mine[-1].done and mine[-1].finish_reason == c.finish_reason
        if c.logprobs:
            assert [x.logprob for x in mine] == c.logprobs
    # abandoning the stream cancels what is still queued or in flight
    jllm = JaxLLM(jm, tree, slots=2, max_len=64)
    got_it = llm.stream(prompts, params)
    want_it = jllm.stream(prompts, _params_mix(JaxSP, 4))
    got_c = [next(got_it) for _ in range(5)]
    want_c = [next(want_it) for _ in range(5)]
    got_it.close()
    want_it.close()
    assert [(c.index, c.token) for c in got_c] == [(c.index, c.token) for c in want_c]
    reasons = sorted((r.uid, r.finish_reason, len(r.output or [])) for r in llm.engine.done[-4:])
    want_r = sorted((r.uid - 4, r.finish_reason, len(r.output or [])) for r in jllm.engine.done)
    assert [x[1:] for x in reasons] == [x[1:] for x in want_r]
    assert "cancelled" in [x[1] for x in reasons]
    assert llm.engine.health().active_slots == 0 and not llm.engine.queue


def test_steady_decode_step_makes_one_host_transfer(pair, monkeypatch):
    """A steady engine step copies the sampled (tok, logp, bad) triple to the
    host once, through ``to_host``, and reads no tensor on the host any
    other way (the reference's transfer-guard test, with the tensor-to-host
    methods made to raise)."""
    _, _, model = pair
    llm = LLM(model, slots=2, max_len=64)
    eng = llm.engine
    for i, p in enumerate(_prompts(2, seed=13)):
        eng.submit(engine_mod.Request(uid=i, prompt=np.asarray(p, np.int32),
                                      params=SamplingParams(temperature=0.7, seed=i, max_new=20)))
    eng.step()            # admissions + first decode
    eng.step()

    def banned(*a, **k):
        raise AssertionError("host read of a tensor inside the decode step")

    for name in ("item", "tolist", "__bool__", "__int__", "__float__", "__index__", "nonzero"):
        monkeypatch.setattr(torch.Tensor, name, banned)
    before = engine_mod.to_host.transfers
    for _ in range(3):
        assert eng.step() == 2
    monkeypatch.undo()
    assert engine_mod.to_host.transfers - before == 3
    assert all(len(r.output) == 6 for r in eng.slot_req)   # 1 + 1 + 1 + 3 steps


def test_to_host_round_trips_dtypes():
    tok = torch.tensor([3, -1, 2**31 - 1], dtype=torch.int32)
    logp = torch.tensor([-0.5, float("nan"), -1e30])
    bad = torch.tensor([True, False, True])
    t, lp, b = engine_mod.to_host(tok, logp, bad)
    assert t.dtype == np.int32 and t.tolist() == [3, -1, 2**31 - 1]
    assert lp.dtype == np.float32 and np.array_equal(lp, logp.numpy(), equal_nan=True)
    assert b.dtype == bool and b.tolist() == [True, False, True]


def test_serve_config_maps_and_paged_layout_raises(pair):
    """The dense fields map onto the engine; so do the paged layout's
    (page size, prefix cache, chunked prefill, preemption), and the paged
    layout raises where the reference's does: for a sliding-window model,
    and its features on the dense layout."""
    _, _, model = pair
    sc = ServeConfig(max_seq_len=96, batch_size=3, temperature=0.7, top_k=5, top_p=0.9,
                     seed=11, max_queue=7, deadline_ms=500.0)
    llm = LLM.from_config(model, sc)
    assert (llm.engine.slots, llm.engine.max_len, llm.engine.max_queue) == (3, 96, 7)
    assert llm.default_params == SamplingParams(temperature=0.7, top_k=5, top_p=0.9, seed=11,
                                                deadline_ms=500.0)
    assert llm.engine.cache is None     # the cache comes with the first submit
    paged = LLM.from_config(model, dataclasses.replace(
        sc, cache_layout="paged", page_size=8, prefix_cache=True, prefill_chunk=32,
        preempt=True)).engine
    assert (paged.layout, paged.alloc.page_size, paged.prefix_cache, paged.prefill_chunk,
            paged.preempt, paged.max_queue) == ("paged", 8, True, 32, True, 7)
    assert paged.alloc.num_pages == 1 + 3 * 12 and paged.cache is None
    with pytest.raises(ValueError, match="sliding-window"):
        LLM.from_config(Model(dataclasses.replace(model.cfg, sliding_window=8),
                              model.params.tree()), dataclasses.replace(sc, cache_layout="paged"))
    with pytest.raises(ValueError, match="require cache_layout='paged'"):
        LLM.from_config(model, dataclasses.replace(sc, prefix_cache=True))
    with pytest.raises(ValueError, match="overflows"):
        llm.generate([[1] * 90], SamplingParams(max_new=10))
    assert llm.engine.cache is None and llm.engine.counters["submitted"] == 0


def test_qwen2_7b_config_and_bf16_serving_params():
    cfg = get_config("qwen2-7b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
            cfg.d_ff, cfg.vocab_size, cfg.padded_vocab) == (28, 3584, 28, 4, 128, 18944, 152064, 152064)
    assert cfg == ModelConfig(**dataclasses.asdict(jax_configs.get_config("qwen2-7b")))
    # serving from bf16 parameters: the weight casts of a step are no-ops
    small = dataclasses.replace(_jcfg(), param_dtype="bfloat16", dtype="bfloat16")
    model = build_model(ModelConfig(**dataclasses.asdict(small)), device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    out = LLM(model, slots=2, max_len=32).generate(_prompts(2, seed=2), SamplingParams(max_new=4))
    assert [len(c.tokens) for c in out] == [4, 4]
