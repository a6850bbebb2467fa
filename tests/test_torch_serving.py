"""The port's ``LLM.embed`` against the reference's on reduced(esm2-650m)
with bridged weights, plus the behaviour the reference's embed tests pin:
input order, determinism, batch-composition independence, validation
messages and lifecycle counters."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving.api import LLM as JaxLLM  # noqa: E402
from repro_torch.checkpoint.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.config import ModelConfig, ServeConfig  # noqa: E402
from repro_torch.models.model import Model, build_model  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.obs.trace import TraceRecorder  # noqa: E402
from repro_torch.serving.api import LLM  # noqa: E402


def _prompts(n=9, lo=3, hi=60, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(5, 30, size=int(L)).tolist() for L in rng.integers(lo, hi, size=n)]


def _port_llm(slots=3, max_len=64, **kw):
    return LLM(build_model(get_smoke_config("esm2-650m"), device="cpu", seed=0),
               slots=slots, max_len=max_len, **kw)


def test_embed_matches_reference_llm_embed():
    jcfg = jax_configs.get_smoke_config("esm2-650m")
    jmodel = jax_build_model(jcfg)
    rng = np.random.default_rng(1)
    tree = jax.tree.map(
        lambda a: a + (0.1 * rng.standard_normal(a.shape)).astype(a.dtype) if a.ndim <= 2 else a,
        jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0))),
    )  # non-zero biases and non-unit norm scales
    prompts = _prompts(11)   # buckets 8..64, several 3-row chunks each
    want = JaxLLM(jmodel, tree, slots=3, max_len=64).embed(prompts)
    model = Model(ModelConfig(**dataclasses.asdict(jcfg)), from_jax_params(tree))
    trace = TraceRecorder()
    got = LLM(model, slots=3, max_len=64, trace=trace).embed(prompts)
    buckets = [e["bucket"] for e in trace.events() if e["event"] == "prefill"]
    assert len(set(buckets)) >= 3 and len(buckets) > len(set(buckets))
    assert got.shape == want.shape == (11, jcfg.d_model) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_embed_input_order_and_determinism():
    llm = _port_llm(slots=2)
    prompts = _prompts(9)
    a = llm.embed(prompts)
    assert np.array_equal(a, llm.embed(prompts))
    perm = [4, 0, 8, 2, 6, 1, 7, 3, 5]
    np.testing.assert_allclose(llm.embed([prompts[i] for i in perm]), a[perm], atol=1e-5)


def test_embed_independent_of_batch_composition():
    llm = _port_llm(slots=4)
    prompts = _prompts(6, lo=10, hi=14)   # one bucket, shared dispatches
    together = llm.embed(prompts)
    alone = np.stack([llm.embed([p])[0] for p in prompts])
    np.testing.assert_allclose(together, alone, atol=1e-5)


def test_embed_validation():
    llm = _port_llm(slots=2, max_len=32)
    with pytest.raises(ValueError, match="overflows"):
        llm.embed([[1] * 33])
    with pytest.raises(ValueError, match="empty"):
        llm.embed([[1, 2], []])
    assert llm.embed([]).shape == (0, 256)
    assert llm.engine.counters["submitted"] == 0


def test_embed_counters_metrics_and_trace():
    reg, tr = MetricsRegistry(), TraceRecorder()
    clock = iter(float(i) for i in range(100))
    llm = _port_llm(slots=3, metrics=reg, trace=tr, clock=lambda: next(clock))
    llm.embed(_prompts(5))
    c = llm.engine.counters
    assert c["submitted"] == c["completed"] == 5
    evs = tr.events()
    assert {e["event"] for e in evs} == {"prefill", "finish"}
    assert sum(e["rows"] for e in evs if e["event"] == "prefill") == 5
    assert evs[-1]["embedded"] == 5 and evs[-1]["wall"] > 0
    vals = {r["name"]: r.get("value") for r in reg.snapshot()}
    assert vals['engine_requests_total{event="submitted"}'] == 5
    assert vals['engine_requests_total{event="completed"}'] == 5


def test_llm_from_serve_config():
    model = build_model(get_smoke_config("esm2-650m"), device="cpu")
    llm = LLM.from_config(model, ServeConfig(max_seq_len=128, batch_size=5))
    assert (llm.engine.slots, llm.engine.max_len) == (5, 128)
