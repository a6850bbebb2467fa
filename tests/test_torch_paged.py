"""The port's paged KV layout against the reference on the CPU: the page
allocator state step for step through a seeded random sequence,
``Model.prefill_chunk`` on bridged reduced(qwen2-7b, num_kv_heads=2)
weights in fp32, and the paged engine's ``LLM.generate`` token for token —
prefix caching cold and warm, chunked prefill, preemption under a tight
pool, crash-and-rebuild and a deadline storm, and the health page counts."""
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
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.faults import FaultPlan as JaxFaultPlan  # noqa: E402
from repro.serving.faults import crash_and_rebuild as jax_crash_and_rebuild  # noqa: E402
from repro.serving.faults import deadline_storm as jax_deadline_storm  # noqa: E402
from repro.serving.paged_cache import PageAllocator as JaxAllocator  # noqa: E402
from repro.serving.sampling import SamplingParams as JaxSP  # noqa: E402
from repro_torch.checkpoint.bridge import from_jax_params  # noqa: E402
from repro_torch.core.config import ModelConfig, ServeConfig  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving.api import LLM  # noqa: E402
from repro_torch.serving.faults import FaultPlan, crash_and_rebuild, deadline_storm  # noqa: E402
from repro_torch.serving.paged_cache import NULL_PAGE, PageAllocator, block_hashes  # noqa: E402
from repro_torch.serving.sampling import SamplingParams  # noqa: E402

PAGE = 8


def _jcfg():
    return jax_reduced(jax_configs.get_config("qwen2-7b"), num_kv_heads=2)


@pytest.fixture(scope="module")
def pair():
    """(reference model, its param tree, the port's model on the same
    weights); the zero biases and unit norm scales are perturbed so every
    one of them matters."""
    jcfg = _jcfg()
    rng = np.random.default_rng(0)
    tree = jax.tree.map(np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    tree = jax.tree.map(
        lambda a: a + (0.1 * rng.standard_normal(a.shape)).astype(a.dtype) if a.ndim <= 2 else a,
        tree)
    return jax_build_model(jcfg), tree, Model(ModelConfig(**dataclasses.asdict(jcfg)),
                                              from_jax_params(tree))


def _shared_prompts(n, seed, vocab=500, preamble=24):
    """Half the prompts start with one shared preamble (full blocks and a
    partial one), as the reference's serve launcher builds them; the last
    two are the preamble alone (a whole-prompt hit: copy-on-write)."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, vocab, size=preamble).tolist()
    out = []
    for i, L in enumerate(rng.integers(3, 22, size=n - 2)):
        tail = rng.integers(0, vocab, size=int(L)).tolist()
        out.append(pre + tail if i % 2 else tail)
    return out + [list(pre), list(pre)]


def _params(SP, n, max_new=6):
    base = [SP(max_new=max_new),
            SP(temperature=0.8, top_k=20, top_p=0.9, seed=3, max_new=max_new, logprobs=True),
            SP(temperature=1.1, seed=2**31 + 5, max_new=max_new - 1)]
    return (base * n)[:n]


def _same(got, want):
    """Identical tokens and finish reasons; logprobs at 1e-4 (fp32 logits
    of the same products summed in another order)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.tokens == w.tokens, (g.index, g.tokens, w.tokens)
        assert g.finish_reason == w.finish_reason, (g.index, g.finish_reason, w.finish_reason)
        if w.logprobs is not None:
            np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-4, rtol=0)


# ------------------------------------------------------------------ the allocator
def _state(a):
    return (a.table.tolist(), list(a._free), a._ref.tolist(), dict(a._page_of),
            dict(a._hash_of), dict(a._block_of), list(a._evictable), dict(a.stats),
            [list(p) for p in a._owned], list(a._tokens), a.free_pages)


def test_page_allocator_matches_reference_step_for_step():
    """One seeded random sequence of plan / alloc / register / append /
    cow_write / release / drop_cache on both allocators: every return value
    and the whole state (tables, free list, refcounts, hash index, LRU
    order, stats) stay equal, and the invariants hold, at every step."""
    rng = np.random.default_rng(0)
    slots, max_len, num_pages = 4, 64, 20
    mine = PageAllocator(num_pages, PAGE, slots, max_len, prefix_cache=True)
    ref = JaxAllocator(num_pages, PAGE, slots, max_len, prefix_cache=True)
    stems = [rng.integers(0, 50, size=int(n)) for n in (8, 16, 20, 33)]
    prompts = {}
    kinds = []
    for step in range(400):
        kind = rng.choice(["alloc", "alloc", "register", "append", "cow", "release", "drop"])
        busy = [s for s in range(slots) if mine.owned(s)]
        idle = [s for s in range(slots) if not mine.owned(s)]
        if kind == "alloc" and idle:
            slot = int(rng.choice(idle))
            stem = stems[int(rng.integers(len(stems)))]
            tail = rng.integers(0, 50, size=int(rng.integers(0, 12)))
            prompt = np.concatenate([stem, tail]).astype(np.int32)[: max_len - 8]
            tokens = len(prompt) + int(rng.integers(1, 8))
            plan_a, plan_b = mine.plan(tokens, prompt), ref.plan(tokens, prompt)
            assert dataclasses.astuple(plan_a) == dataclasses.astuple(plan_b)
            ok = mine.can_admit(tokens, plan_a)
            assert ok == ref.can_admit(tokens, plan_b)
            if ok:
                got = mine.alloc(slot, tokens, plan_a)
                want = ref.alloc(slot, tokens, plan_b)
                assert got.tolist() == want.tolist() and mine.last_cow == ref.last_cow
                prompts[slot] = prompt
        elif kind == "register" and busy:
            slot = int(rng.choice(busy))
            assert mine.register(slot, prompts[slot]) == ref.register(slot, prompts[slot])
        elif kind == "append" and busy:
            slot = int(rng.choice(busy))
            n = int(rng.integers(1, 10))
            grow = (mine._tokens[slot] + n <= mine.capacity
                    and -(-(mine._tokens[slot] + n) // PAGE) - len(mine.owned(slot))
                    <= mine.free_pages)
            if grow:
                mine.append(slot, n)
                ref.append(slot, n)
        elif kind == "cow" and busy:
            slot = int(rng.choice(busy))
            idx = int(rng.integers(len(mine.owned(slot))))
            if mine.ref(mine.owned(slot)[idx]) <= 1 or mine.free_pages:
                assert mine.cow_write(slot, idx) == ref.cow_write(slot, idx)
        elif kind == "release" and busy:
            slot = int(rng.choice(busy))
            assert mine.releasable(slot) == ref.releasable(slot)
            assert mine.release(slot) == ref.release(slot)
        elif kind == "drop":
            assert mine.drop_cache() == ref.drop_cache()
        else:
            continue
        kinds.append(kind)
        assert _state(mine) == _state(ref), (step, kind)
        mine.check_invariants()
    assert mine.stats["hit_tokens"] > 0 and mine.stats["cow_copies"] > 0
    assert mine.stats["evictions"] > 0 and len(set(kinds)) == 6


def test_block_hashes_chain_and_null_page_is_never_handed_out():
    toks = np.arange(20, dtype=np.int32)
    h = block_hashes(toks, PAGE)
    assert len(h) == 2 and block_hashes(toks[:16], PAGE) == h
    assert block_hashes(np.concatenate([toks[8:16], toks[:8]]), PAGE)[1] != h[1]
    a = PageAllocator(5, PAGE, 2, 32)
    pages = a.alloc(0, 32).tolist()
    assert NULL_PAGE not in pages and sorted(pages) == [1, 2, 3, 4]
    assert not a.can_admit(1) and (a.table[1] == NULL_PAGE).all()


# ------------------------------------------------------------------ Model.prefill_chunk
@pytest.mark.parametrize("chunk", [1, 5, 23])
def test_prefill_chunk_matches_reference(pair, chunk):
    """A 23-token prompt in chunks of 1, 5 and all 23, each right-padded to
    a power-of-2 bucket, into shuffled pages: the last valid row's logits
    after every chunk and the pools' live rows at the end."""
    jm, tree, model = pair
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, 500, size=23).astype(np.int32)
    max_len, num_pages = 40, 9
    table = np.array([[6, 2, 8, 0, 0]], np.int32)     # 23 rows on 3 pages of 8
    layers = model.init_cache(1, max_len, layout="paged", page_size=PAGE,
                              num_pages=num_pages)["layers"]
    jlayers = jm.init_cache(1, max_len, layout="paged", page_size=PAGE,
                            num_pages=num_pages)["layers"]
    jchunk = jax.jit(jm.prefill_chunk)
    params = model.params.tree()
    done = 0
    while done < len(prompt):
        c = min(chunk, len(prompt) - done)
        bucket = 1 << max(3, (c - 1).bit_length())
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :c] = prompt[done : done + c]
        lg, layers = model.prefill_chunk(params, layers, torch.from_numpy(toks),
                                         torch.from_numpy(table), done, c)
        jlg, jlayers = jchunk(tree, jlayers, jnp.asarray(toks), jnp.asarray(table),
                              jnp.int32(done), jnp.int32(c))
        assert lg.shape == (1, 1, model.cfg.padded_vocab)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4, rtol=0,
                                   err_msg=f"chunk at {done}")
        done += c
    pos = np.arange(len(prompt))
    pages, rows = table[0, pos // PAGE], pos % PAGE
    attn = layers["sub0"]["attn"]
    for name in ("k_pool", "v_pool"):
        want = np.asarray(jlayers["sub0"]["attn"][name])
        assert tuple(attn[name].shape) == want.shape == (2, num_pages, PAGE, 2, 64)
        np.testing.assert_allclose(attn[name].numpy()[:, pages, rows], want[:, pages, rows],
                                   atol=1e-5, rtol=0)


# ------------------------------------------------------------------ the paged engine
def test_paged_engine_prefix_cache_and_chunks_match_reference(pair):
    """Prefix caching with chunked prefill, cold then warm (the second call
    hits the first call's registered blocks), chunks alone and the one-shot
    paged admission: tokens as the reference's; allocator stats and the health
    page counts as the reference's; the source page of a whole-prompt hit is
    never written."""
    jm, tree, model = pair
    prompts = _shared_prompts(8, seed=1)
    kw = dict(slots=3, max_len=64, cache_layout="paged", page_size=PAGE, prefix_cache=True,
              prefill_chunk=5)
    llm, jllm = LLM(model, **kw), JaxLLM(jm, tree, **kw)
    cold = llm.generate(prompts, _params(SamplingParams, 8))
    _same(cold, jllm.generate(prompts, _params(JaxSP, 8)))
    eng, jeng = llm.engine, jllm.engine
    assert eng.alloc.stats == jeng.alloc.stats and eng.alloc.stats["cow_copies"] >= 1
    cold_hits = eng.alloc.stats["hit_tokens"]
    # the warm call: the cached preamble pages stay bit for bit what the
    # cold call wrote, though every prompt of the warm call hits them
    hit = [p for p in eng.alloc._hash_of]
    pools = eng.cache["layers"]["sub0"]["attn"]
    before = [pools[n][:, hit].clone() for n in ("k_pool", "v_pool")]
    warm = llm.generate(prompts, _params(SamplingParams, 8))
    _same(warm, jllm.generate(prompts, _params(JaxSP, 8)))
    assert [c.tokens for c in warm] == [c.tokens for c in cold]
    assert all(torch.equal(pools[n][:, hit], b) for n, b in zip(("k_pool", "v_pool"), before))
    assert eng.alloc.stats == jeng.alloc.stats
    assert eng.alloc.stats["hit_tokens"] > 2 * cold_hits
    h, jh = eng.health(), jeng.health()
    assert (h.prefilling, h.free_pages, h.total_pages) == \
        (jh.prefilling, jh.free_pages, jh.total_pages) == (0, 24, 24)
    assert h.counters == jh.counters
    eng.alloc.check_invariants()
    # chunks alone, the one-shot paged admission (no prefix cache, no
    # chunks) and the dense layout give the same tokens
    chunks = LLM(model, slots=3, max_len=64, cache_layout="paged", page_size=PAGE,
                 prefill_chunk=5)
    one = LLM(model, slots=3, max_len=64, cache_layout="paged", page_size=PAGE)
    dense = LLM(model, slots=3, max_len=64)
    for other in (chunks, one, dense):
        assert [c.tokens for c in other.generate(prompts, _params(SamplingParams, 8))] == \
            [c.tokens for c in cold]


def test_paged_engine_preempts_and_resumes_like_reference(pair):
    """A tight pool with preemption: requests are evicted and replayed, and
    every output is the reference's — which is also the output of a roomy
    pool that never preempts."""
    jm, tree, model = pair
    prompts = _shared_prompts(8, seed=2)
    kw = dict(slots=3, max_len=64, cache_layout="paged", page_size=PAGE, num_pages=10,
              prefix_cache=True, prefill_chunk=8, preempt=True)
    llm = LLM(model, **kw)
    got = llm.generate(prompts, _params(SamplingParams, 8, max_new=12))
    jllm = JaxLLM(jm, tree, **kw)
    _same(got, jllm.generate(prompts, _params(JaxSP, 8, max_new=12)))
    c, jc = llm.engine.health().counters, jllm.engine.health().counters
    assert c == jc and c["preempted"] >= 1 and c["resumed"] == c["preempted"]
    roomy = LLM(model, slots=3, max_len=64, cache_layout="paged", page_size=PAGE)
    assert [x.tokens for x in roomy.generate(prompts, _params(SamplingParams, 8, max_new=12))] \
        == [x.tokens for x in got]
    eng = llm.engine
    eng.alloc.check_invariants()
    assert eng.alloc.free_pages == eng.alloc.num_pages - 1


def test_paged_crash_and_rebuild_under_a_deadline_storm_match_reference(pair):
    """A deadline storm on a seeded subset, then a hard crash at step 5 and a
    rebuilt engine: finish reasons and tokens as the reference's, on an
    engine clock of 10 ms a step."""
    jm, tree, model = pair
    prompts = _shared_prompts(6, seed=3)
    sps = _params(SamplingParams, 6, max_new=8)
    jsps = _params(JaxSP, 6, max_new=8)

    def requests(R, SP_list):
        return [R(uid=i, prompt=np.asarray(p, np.int32), params=sp)
                for i, (p, sp) in enumerate(zip(prompts, SP_list))]

    def stepped(eng):
        eng._clock = lambda: eng.steps * 0.01
        return eng

    kw = dict(slots=2, max_len=64, cache_layout="paged", page_size=PAGE, prefix_cache=True,
              prefill_chunk=8)
    reqs, jreqs = requests(engine_mod.Request, sps), requests(JaxRequest, jsps)
    hit = deadline_storm(reqs, seed=7, fraction=0.5, deadline_ms=(30.0, 120.0))
    assert hit and hit == jax_deadline_storm(jreqs, seed=7, fraction=0.5,
                                             deadline_ms=(30.0, 120.0))
    done, crashed = crash_and_rebuild(
        lambda: stepped(LLM(model, faults=FaultPlan(crash_at=5), **kw).engine), reqs)
    jdone, jcrashed = jax_crash_and_rebuild(
        lambda: stepped(JaxEngine(jm, tree, faults=JaxFaultPlan(crash_at=5), **kw)), jreqs)
    assert crashed and jcrashed and len(done) == len(jdone) == 6
    got = sorted((r.uid, r.finish_reason, list(r.output or [])) for r in done)
    want = sorted((r.uid, r.finish_reason, list(r.output or [])) for r in jdone)
    assert got == want
    reasons = {x[1] for x in got}
    assert "timeout" in reasons and reasons & {"length", "stop"}


def test_paged_serve_config_and_validation(pair):
    _, _, model = pair
    sc = ServeConfig(max_seq_len=64, batch_size=2, cache_layout="paged", page_size=4,
                     prefix_cache=True, prefill_chunk=16, preempt=True)
    eng = LLM.from_config(model, sc, num_pages=9).engine
    assert (eng.layout, eng.alloc.page_size, eng.alloc.num_pages, eng.prefix_cache,
            eng.prefill_chunk, eng.preempt) == ("paged", 4, 9, True, 16, True)
    assert eng.cache is None and eng.health().total_pages == 8
    with pytest.raises(ValueError, match="never fit"):
        eng.submit(engine_mod.Request(uid=0, prompt=np.arange(30, dtype=np.int32), max_new=10))
    for bad in (dict(prefix_cache=True), dict(prefill_chunk=8), dict(preempt=True)):
        with pytest.raises(ValueError, match="paged"):
            LLM(model, slots=2, max_len=32, **bad)
    windowed = Model(dataclasses.replace(model.cfg, sliding_window=8), model.params.tree())
    with pytest.raises(ValueError, match="sliding-window"):
        LLM(windowed, slots=2, max_len=32, cache_layout="paged")


def test_paged_steady_decode_step_makes_one_host_transfer(pair, monkeypatch):
    """A steady paged step reads no tensor on the host but through the one
    ``to_host`` copy, and does not move the block table."""
    _, _, model = pair
    llm = LLM(model, slots=2, max_len=64, cache_layout="paged", page_size=PAGE,
              prefix_cache=True, prefill_chunk=8)
    eng = llm.engine
    for i, p in enumerate(_shared_prompts(4, seed=4)[:2]):
        eng.submit(engine_mod.Request(uid=i, prompt=np.asarray(p, np.int32),
                                      params=SamplingParams(temperature=0.7, seed=i, max_new=20)))
    while eng._prefilling or eng.queue:
        eng.step()
    eng.step()
    table = eng.cache["block_table"]

    def banned(*a, **k):
        raise AssertionError("host read of a tensor inside the decode step")

    for name in ("item", "tolist", "__bool__", "__int__", "__float__", "__index__", "nonzero"):
        monkeypatch.setattr(torch.Tensor, name, banned)
    before = engine_mod.to_host.transfers
    for _ in range(3):
        assert eng.step() == 2
    monkeypatch.undo()
    assert engine_mod.to_host.transfers - before == 3
    assert eng.cache["block_table"] is table
