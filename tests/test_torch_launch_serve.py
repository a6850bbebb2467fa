"""The port's single-device serving launcher (``launch/serve.py``:
``serve_continuous``, ``_health_line``, ``main``) against the reference's
on the CPU: reduced(qwen2-7b, num_kv_heads=2) on bridged fp32 weights,
both launchers' ``serve_continuous`` over the same load.  The completions
are captured by wrapping each package's ``LLM.generate`` on the test side;
the tokens of every request, the allocator's prefix-cache statistics and
the health lines (printed by the ``on_step`` callback every step, and at
exit) must be equal.  Then ``main`` end to end on the CPU, and the mesh it
refuses."""
import dataclasses
import json
import os
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.core.config import ServeConfig as JaxServeConfig  # noqa: E402
from repro.core.config import reduced as jax_reduced  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving.api import LLM as JaxLLM  # noqa: E402
from repro_torch.checkpoint.bridge import from_jax_params  # noqa: E402
from repro_torch.core.config import ModelConfig, ServeConfig  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.api import LLM  # noqa: E402
from repro_torch.serving.sampling import SamplingParams  # noqa: E402


@pytest.fixture(scope="module")
def pair():
    """(reference model, its param tree, the port's model on the same
    weights); biases and norm scales perturbed so each one matters."""
    jcfg = jax_reduced(jax_configs.get_config("qwen2-7b"), num_kv_heads=2)
    rng = np.random.default_rng(0)
    tree = jax.tree.map(np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    tree = jax.tree.map(
        lambda a: a + (0.1 * rng.standard_normal(a.shape)).astype(a.dtype) if a.ndim <= 2 else a,
        tree)
    return jax_build_model(jcfg), tree, Model(ModelConfig(**dataclasses.asdict(jcfg)),
                                              from_jax_params(tree))


def _capture(monkeypatch, cls, num_pages=0):
    """Record each ``cls.generate`` call's (llm, prompts, params,
    completions); with ``num_pages``, ``cls.from_config`` builds a pool of
    that many pages (page pressure, so the engine preempts)."""
    calls = []
    gen = cls.generate

    def spy(self, prompts, params=None, **kw):
        outs = gen(self, prompts, params, **kw)
        calls.append((self, prompts, params, outs))
        return outs

    monkeypatch.setattr(cls, "generate", spy)
    if num_pages:
        build = cls.from_config
        monkeypatch.setattr(cls, "from_config",
                            staticmethod(lambda *a, **kw: build(*a, num_pages=num_pages, **kw)))
    return calls


def _health_lines(out):
    """The printed health lines: every ``[step N]`` line and the exit's."""
    return [ln.strip() for ln in out.splitlines() if "[step " in ln or "health:" in ln]


# greedy over the dense layout; seeded sampling over the paged layout with
# the prefix cache, 16-token chunks and preemption under a 12-page pool
CASES = {
    "dense": (dict(cache_layout="dense"), 0),
    "paged": (dict(cache_layout="paged", page_size=8, prefix_cache=True, prefill_chunk=16,
                   preempt=True, temperature=0.8, top_k=40, top_p=0.95, seed=7), 12),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_serve_continuous_matches_reference(name, pair, monkeypatch, capsys, tmp_path):
    jm, tree, model = pair
    kw, num_pages = CASES[name]
    gen, prompt_len, requests = 6, 20, 10
    max_prompt = prompt_len * (2 if kw.get("prefix_cache") else 1)
    sc_kw = dict(max_seq_len=max_prompt + gen + 1, batch_size=4, **kw)
    run = dict(gen=gen, prompt_len=prompt_len, requests=requests, health_every=1)

    jcalls = _capture(monkeypatch, JaxLLM, num_pages)
    jax_serve.serve_continuous(jm, tree, JaxServeConfig(**sc_kw), **run)
    jout = capsys.readouterr().out
    calls = _capture(monkeypatch, LLM, num_pages)
    serve.serve_continuous(model, None, ServeConfig(**sc_kw), **run,
                           metrics_dir=str(tmp_path / "m"), trace_path=str(tmp_path / "t.jsonl"))
    out = capsys.readouterr().out

    (jllm, jprompts, jparams, jouts), = jcalls
    (llm, prompts, params, outs), = calls
    assert len(prompts) == requests
    assert all(np.array_equal(a, b) for a, b in zip(prompts, jprompts))
    assert [p.seed for p in params] == [p.seed for p in jparams]
    for got, want in zip(outs, jouts):
        assert got.tokens == want.tokens, (got.index, got.tokens, want.tokens)
        assert got.finish_reason == want.finish_reason == "length"
    eng, jeng = llm.engine, jllm.engine
    # on_step fired once a step in both (health_every=1): a line a step
    lines, jlines = _health_lines(out), _health_lines(jout)
    assert len(lines) == eng.steps + 1 and eng.steps == jeng.steps > requests
    assert lines == jlines
    summary = re.search(r"served (\d+)/(\d+) requests / (\d+) tokens on (\d+) slots", out)
    assert summary.groups() == (str(requests), str(requests), str(requests * gen), "4")
    if name == "paged":
        st, jst = eng.alloc.stats, jeng.alloc.stats
        assert {k: st[k] for k in ("hit_tokens", "evictions", "cow_copies")} == \
            {k: jst[k] for k in ("hit_tokens", "evictions", "cow_copies")}
        assert st["hit_tokens"] > 0 and eng.counters["preempted"] > 0
        assert eng.counters == jeng.counters
        assert f"{st['hit_tokens']} tokens reused" in out
        assert eng.alloc.free_pages == num_pages - 1
    # the metrics files and the lifecycle trace
    assert sorted(os.listdir(tmp_path / "m")) == ["serve.prom", "serve_metrics.json"]
    assert "engine_requests_total" in (tmp_path / "m" / "serve.prom").read_text()
    events = [json.loads(ln) for ln in (tmp_path / "t.jsonl").read_text().splitlines()]
    assert sum(e["event"] == "finish" for e in events) == requests


def test_on_step_fires_once_a_step(pair):
    _, _, model = pair
    seen = []
    llm = LLM(model, slots=2, max_len=32, on_step=lambda eng: seen.append(eng.steps))
    llm.generate([[5, 6, 7], [8, 9]], SamplingParams(max_new=3))
    assert seen == list(range(1, llm.engine.steps + 1))
    sc = ServeConfig(max_seq_len=32, batch_size=2)
    again = LLM.from_config(model, sc, on_step=lambda eng: seen.append(-eng.steps))
    again.generate([[5, 6, 7]], SamplingParams(max_new=2))
    assert seen[-again.engine.steps:] == [-s for s in range(1, again.engine.steps + 1)]


def test_main_serves_end_to_end_on_the_cpu(tmp_path, capsys):
    serve.main(["--arch", "qwen2-7b", "--smoke", "--continuous", "--device", "cpu",
                "--cache-layout", "paged", "--page-size", "8", "--prefix-cache",
                "--prefill-chunk", "16", "--requests", "4", "--prompt-len", "16", "--gen", "3",
                "--batch", "3", "--health-every", "2", "--metrics-dir", str(tmp_path / "m"),
                "--trace", str(tmp_path / "t.jsonl"), "--profile", str(tmp_path / "p"),
                "--mesh", "1x1"])
    out = capsys.readouterr().out
    assert "[paged] served 4/4 requests / 12 tokens on 3 slots" in out
    assert "[step 2]" in out and "step timer:" in out and "decode:" in out
    assert sorted(os.listdir(tmp_path / "m")) == ["serve.prom", "serve_metrics.json"]
    assert (tmp_path / "t.jsonl").read_text().count('"finish"') == 4
    assert any(f.endswith(".pt.trace.json") for f in os.listdir(tmp_path / "p"))
    # the static batch (MolMIM's encoder-decoder)
    serve.main(["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "6", "--gen", "3"])
    assert "generated (2, 3) tokens" in capsys.readouterr().out


@pytest.mark.parametrize("spec", ["2x4", "1x2", "2"])
def test_main_refuses_a_mesh_of_several_devices(spec):
    with pytest.raises(SystemExit, match="--mesh"):
        serve.main(["--smoke", "--continuous", "--device", "cpu", "--mesh", spec])


def test_main_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke", "--continuous"])
