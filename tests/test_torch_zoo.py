"""The rest of the zoo's decoder and encoder configs against the reference
package on bridged weights: Geneformer-106M (learned positions, biases
everywhere, the MLM loss), Command-R-35B (a parallel residual, bias-free
LayerNorm), Qwen1.5-32B (MHA, QKV bias) and Llama-3-405B (GQA), each at
``reduced()`` size on the CPU.  ``reduced()`` turns Command-R and Llama-3
into MHA (4 q / 4 kv heads), so their cases run again with one kv head on
both sides, which keeps a GQA group.

fp32 runs against the reference's default CPU path; bf16 against the
reference with REPRO_FORCE_IMPL=pallas_interpret (its TPU kernels' own
math), as ``test_torch_model.py`` does."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.core.config import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.core.config import reduced as jax_reduced  # noqa: E402
from repro.core.precision import compute_view as jax_compute_view  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.parallel.sharding import null_ctx  # noqa: E402
from repro.serving.api import LLM as JaxLLM  # noqa: E402
from repro.serving.sampling import SamplingParams as JaxSP  # noqa: E402
from repro.training import train_step as jax_ts  # noqa: E402
from repro_torch.checkpoint.bridge import from_jax_params, to_jax_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.config import ModelConfig, TrainConfig  # noqa: E402
from repro_torch.core.module import tree_leaves, tree_map  # noqa: E402
from repro_torch.core.precision import compute_view  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.model import Model, build_model, param_defs  # noqa: E402
from repro_torch.serving.api import LLM  # noqa: E402
from repro_torch.serving.sampling import SamplingParams  # noqa: E402
from repro_torch.training.train_step import init_train_state, make_train_step  # noqa: E402
from test_torch_model import _params  # noqa: E402

ZOO = ["geneformer-106m", "command-r-35b", "qwen1.5-32b", "llama3-405b"]
JBF16 = jnp.dtype(jnp.bfloat16)
MASK_ID = 4          # Geneformer's <mask> (examples/embed_cells.py)


def _configs(name, dtype="float32", **over):
    jcfg = dataclasses.replace(jax_reduced(jax_configs.get_config(name), **over), dtype=dtype)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _mlm_batch(vocab, B, S, seed):
    """Gene tokens with 15% of them masked, as ``embed_cells.py`` builds a
    batch."""
    rng = np.random.default_rng(seed)
    t = rng.integers(5, vocab, size=(B, S)).astype(np.int32)
    pick = rng.random(t.shape) < 0.15
    corrupted = t.copy()
    corrupted[pick] = MASK_ID
    return {"tokens": corrupted, "targets": t, "loss_mask": pick.astype(np.float32)}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("name", ZOO)
def test_config_fields_and_param_tree_equal_the_reference(name):
    """Every field, the citation included; the param paths and shapes at
    full size (shapes only, nothing materialized) and at reduced()."""
    cfg, jcfg = get_config(name), jax_configs.get_config(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for c, jc in ((cfg, jcfg), (_configs(name)[1], _configs(name)[0])):
        want = jax_build_model(jc).abstract_params()
        got = tree_map(lambda p: jax.ShapeDtypeStruct(p.shape, jnp.float32), param_defs(c))
        assert jax.tree.structure(got) == jax.tree.structure(want)
        assert [g.shape for g in jax.tree.leaves(got)] == [w.shape for w in jax.tree.leaves(want)]
    if cfg.parallel_residual:      # one norm a layer: the FFN reads norm1's output
        assert "norm2" not in param_defs(cfg)["layers"]["sub0"]
    if cfg.norm_type == "layernorm_nobias":
        assert list(param_defs(cfg)["layers"]["sub0"]["norm1"]) == ["scale"]


@pytest.mark.parametrize("name", ZOO)
def test_bridge_round_trips_reference_params_bit_exactly(name):
    jcfg, cfg = _configs(name, param_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    port = from_jax_params(tree)
    back = to_jax_params(port, bfloat16=JBF16)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    assert build_model(cfg, device="cpu").params.tree().keys() == port.keys()


# ------------------------------------------------------------------ Geneformer
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_geneformer_embed_pool_matches_reference(dtype, monkeypatch):
    if dtype == "bfloat16":
        monkeypatch.setenv("REPRO_FORCE_IMPL", "pallas_interpret")
    jcfg, cfg = _configs("geneformer-106m", dtype)
    tree = _params(jcfg)
    rng = np.random.default_rng(4)
    toks = rng.integers(5, cfg.vocab_size, size=(3, 40)).astype(np.int32)
    lens = np.array([40, 25, 9], np.int32)
    got = Model(cfg, from_jax_params(tree)).embed_pool(torch.from_numpy(toks),
                                                       torch.from_numpy(lens))
    want = np.asarray(jax_build_model(jcfg).embed_pool(tree, {"tokens": jnp.asarray(toks)},
                                                       jnp.asarray(lens)))
    assert got.dtype == torch.float32 and got.shape == (3, cfg.d_model)
    if dtype == "float32":       # the same math in another summation order
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
        return
    # bf16: each framework rounds every matmul, bias add, GELU and residual
    # add on its own; the pooled mean stays within two bf16 steps of each
    # row's largest element
    step = 2.0 ** (np.floor(np.log2(np.abs(want).max(1, keepdims=True))) - 7)
    assert (np.abs(got.numpy() - want) <= 2 * step).all()


def test_geneformer_loss_and_every_grad_leaf_match_reference():
    jcfg, cfg = _configs("geneformer-106m")
    tree = _params(jcfg)
    batch = _mlm_batch(cfg.vocab_size, 4, 48, seed=1)
    jm = jax_build_model(jcfg)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(jax_compute_view(jm.policy, p), _j(batch)), has_aux=True))(tree)
    model = Model(cfg, from_jax_params(tree))
    params = model.params.tree()
    loss, metrics = model.loss_fn(compute_view(model.policy, params), _t(batch))
    grads = torch.autograd.grad(loss, tree_leaves(params))
    assert float(metrics["tokens"]) == float(jmet["tokens"]) == batch["loss_mask"].sum()
    # fp32 in both, summed in another order
    assert abs(loss.item() - float(jloss)) <= 1e-4
    want = [np.asarray(w) for w in jax.tree.leaves(jgrads)]
    assert len(grads) == len(want)
    top = max(np.abs(w).max() for w in want)
    bk = next(i for i, p in enumerate(tree_leaves(params))
              if p is params["layers"]["sub0"]["attn"]["bk"])
    for i, (g, w) in enumerate(zip(grads, want)):
        if i == bk:
            # without RoPE a key bias shifts every score of a query alike,
            # which the softmax ignores: its exact gradient is 0, and both
            # sides hold only rounding noise
            assert max(np.abs(g.numpy()).max(), np.abs(w).max()) <= 1e-6 * top
            continue
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * np.abs(w).max(), rtol=0)
    # the learned position table trains: rows 0..S-1 only
    pos = next(g for g, p in zip(grads, tree_leaves(params)) if p is params["embed"]["pos"])
    assert pos[:48].abs().sum() > 0 and (pos[48:] == 0).all()


def test_geneformer_three_adamw_steps_match_reference():
    jcfg, cfg = _configs("geneformer-106m")
    tree = _params(jcfg)
    kw = dict(global_batch=4, seq_len=32, learning_rate=1e-3, warmup_steps=1, decay_steps=1,
              total_steps=3, weight_decay=0.1)
    jstep = jax.jit(jax_ts.make_train_step(jax_build_model(jcfg), JaxTrainConfig(**kw)))
    jstate = jax_ts.TrainState(tree, jax_adamw.init_state(tree))
    model = Model(cfg, from_jax_params(tree))
    state, step = init_train_state(model), make_train_step(model, TrainConfig(**kw))
    for i in range(3):
        b = _mlm_batch(cfg.vocab_size, 4, 32, seed=10 + i)
        jstate, jm = jstep(jstate, _j(b))
        state, m = step(state, _t(b))
        assert abs(m["loss"].item() - float(jm["loss"])) <= 1e-5
        assert abs(m["grad_norm"].item() - float(jm["grad_norm"])) <= 1e-4 * float(jm["grad_norm"])
    # Adam divides by sqrt(v): grads that differ in the last bits move a
    # near-zero-gradient weight by up to ~lr (test_torch_train.py's bound)
    want = jax.tree.leaves(jstate.params) + jax.tree.leaves(jstate.opt.mu) \
        + jax.tree.leaves(jstate.opt.nu)
    got = tree_leaves(state.params) + tree_leaves(state.opt.mu) + tree_leaves(state.opt.nu)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-4, rtol=0)


# ------------------------------------------------------------------ learned positions
def test_learned_positions_reach_prefill_chunk_and_decode_step():
    """A learned-position model (reduced Geneformer) adds the position
    table's rows at each token's own position: a paged chunk at start > 0,
    lockstep decode steps and per-slot positions, as the reference's
    ``prefill_chunk`` and ``decode_step`` pass them."""
    jcfg, cfg = _configs("geneformer-106m")
    tree = _params(jcfg, seed=2)
    jm = jax_build_model(jcfg)
    model = Model(cfg, from_jax_params(tree))
    params = model.params.tree()
    rng = np.random.default_rng(6)
    # two chunks of a 19-token prompt into shuffled pages of 8, the second
    # at start 11 and right-padded to a bucket of 16
    table = np.array([[4, 1, 6, 0]], np.int32)
    layers = model.init_cache(1, 32, layout="paged", page_size=8, num_pages=7)["layers"]
    jlayers = jm.init_cache(1, 32, layout="paged", page_size=8, num_pages=7)["layers"]
    prompt = rng.integers(5, cfg.vocab_size, size=19).astype(np.int32)
    jchunk = jax.jit(jm.prefill_chunk)
    for start, n, bucket in ((0, 11, 16), (11, 8, 16)):
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :n] = prompt[start:start + n]
        lg, layers = model.prefill_chunk(params, layers, torch.from_numpy(toks),
                                         torch.from_numpy(table), start, n)
        jlg, jlayers = jchunk(tree, jlayers, jnp.asarray(toks), jnp.asarray(table),
                                        jnp.int32(start), jnp.int32(n))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4, rtol=0,
                                   err_msg=f"chunk at {start}")
    # dense decode: lockstep from a prefill, then rows at their own positions
    toks = rng.integers(5, cfg.vocab_size, size=(3, 9)).astype(np.int32)
    _, cache = model.prefill(params, {"tokens": torch.from_numpy(toks)}, 24)
    _, jcache = jm.prefill(tree, {"tokens": jnp.asarray(toks)}, 24)
    jdecode = jax.jit(jm.decode_step)
    for t in range(6):
        if t == 3:        # per-slot positions, as the serving engine keeps them
            pos = np.array([13, 5, 10], np.int32)
            cache["pos"], jcache["pos"] = torch.from_numpy(pos.copy()), jnp.asarray(pos)
        nxt = rng.integers(5, cfg.vocab_size, size=(3, 1)).astype(np.int32)
        lg, cache = model.decode_step(params, cache, torch.from_numpy(nxt))
        jlg, jcache = jdecode(tree, jcache, jnp.asarray(nxt))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4, rtol=0,
                                   err_msg=f"decode step {t}")


# ------------------------------------------------------------------ the decoders
def _prompts(n, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(L)).tolist() for L in rng.integers(9, 17, size=n)]


def _mix(SP, n):
    """Greedy and seeded rows, log-probabilities on some."""
    base = [SP(max_new=7),
            SP(temperature=0.8, top_k=20, top_p=0.9, seed=3, max_new=7, logprobs=True),
            SP(temperature=1.1, seed=2**31 + 5, max_new=6, logprobs=True)]
    return (base * n)[:n]


def _same(got, want):
    """Identical tokens and finish reasons; logprobs at 1e-4 (fp32 logits
    of the same products summed in another order)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.tokens == w.tokens, (g.index, g.tokens, w.tokens)
        assert g.finish_reason == w.finish_reason
        if w.logprobs is not None:
            np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-4, rtol=0)


def _models(name, **over):
    jcfg, cfg = _configs(name, **over)
    tree = _params(jcfg)
    return jax_build_model(jcfg), tree, Model(cfg, from_jax_params(tree))


@pytest.mark.parametrize("kv", [4, 1], ids=["mha", "gqa4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_command_r_decoder_stack_matches_reference(dtype, kv, monkeypatch):
    """The parallel residual with bias-free LayerNorm, in train and prefill
    mode (the K/V it caches included)."""
    if dtype == "bfloat16":
        monkeypatch.setenv("REPRO_FORCE_IMPL", "pallas_interpret")
    jcfg, cfg = _configs("command-r-35b", dtype, num_kv_heads=kv)
    tree = _params(jcfg)
    x = np.random.default_rng(3).standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]

    def close(got, want):
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        if dtype == "float32":       # the same math in another summation order
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
            return
        # bf16: each framework rounds every matmul, norm and residual add
        # (three terms a layer here) on its own, and layer 0's roundings
        # move layer 1's; measured at most 3 bf16 steps of each row's largest
        # element over three input draws
        top = np.abs(want).max(-1, keepdims=True)
        assert (np.abs(got - want) <= 4 * 2.0 ** (np.floor(np.log2(top)) - 7)).all()

    layers = from_jax_params(tree["layers"])
    for mode in ("train", "prefill"):
        got, cache, _ = transformer.decoder_stack(cfg, layers, torch.from_numpy(x).to(tdt),
                                                  mode=mode)
        want, jcache, _ = jax_transformer.decoder_stack(jcfg, null_ctx(), tree["layers"],
                                                        jnp.asarray(x, jdt), mode=mode)
        close(got, want)
        if mode == "prefill":
            for n in ("k", "v"):
                close(cache["sub0"]["attn"][n], jcache["sub0"]["attn"][n])


@pytest.mark.parametrize("name,kv", [("command-r-35b", 4), ("command-r-35b", 1),
                                     ("qwen1.5-32b", 4), ("llama3-405b", 4),
                                     ("llama3-405b", 1)])
def test_generate_over_the_dense_cache_matches_reference(name, kv):
    jm, tree, model = _models(name, num_kv_heads=kv)
    prompts = _prompts(5, model.cfg.vocab_size, seed=1)
    want = JaxLLM(jm, tree, slots=3, max_len=48).generate(prompts, _mix(JaxSP, 5))
    got = LLM(model, slots=3, max_len=48).generate(prompts, _mix(SamplingParams, 5))
    _same(got, want)


@pytest.mark.parametrize("kv", [4, 1], ids=["mha", "gqa4"])
def test_command_r_generate_over_the_paged_cache_matches_reference(kv):
    """Prefix caching and chunked prefill: half the prompts behind a shared
    preamble, the last two the preamble alone (a whole-prompt hit,
    copy-on-write); chunks of 5 rows, pages of 8."""
    jm, tree, model = _models("command-r-35b", num_kv_heads=kv)
    rng = np.random.default_rng(2)
    pre = rng.integers(0, 500, size=24).tolist()          # three full pages
    prompts = [pre + p if i % 2 else p for i, p in enumerate(_prompts(5, 500, seed=2))]
    prompts += [list(pre), list(pre)]
    kw = dict(slots=3, max_len=64, cache_layout="paged", page_size=8, prefix_cache=True,
              prefill_chunk=5)
    llm, jllm = LLM(model, **kw), JaxLLM(jm, tree, **kw)
    _same(llm.generate(prompts, _mix(SamplingParams, 7)), jllm.generate(prompts, _mix(JaxSP, 7)))
    assert llm.engine.alloc.stats == jllm.engine.alloc.stats
    assert llm.engine.alloc.stats["hit_tokens"] > 0 and llm.engine.alloc.stats["cow_copies"] >= 1


# ------------------------------------------------------------------ the example
def test_embed_cells_example_trains_and_embeds_on_the_cpu(capsys):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "embed_cells_torch.py"
    spec = importlib.util.spec_from_file_location("embed_cells_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    embs = example.main(["--device", "cpu", "--steps", "4"])
    d = get_config("geneformer-106m").d_model
    assert embs.shape == (512, min(d, 256)) and embs.dtype == np.float32
    assert np.isfinite(embs).all()
    assert "embedded 512 cells" in capsys.readouterr().out
