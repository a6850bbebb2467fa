"""The port's model layers against the reference package on bridged
weights: the weight bridge round trip, rope, mlp_apply, attention_apply,
decoder_stack and Model.embed_pool of reduced(esm2-650m).

fp32 runs against the reference's default CPU path.  bf16 runs against the
reference with REPRO_FORCE_IMPL=pallas_interpret, which routes its
attention and norms through the TPU kernels' own math (fp32 QK and PV) —
the math the port's kernels reproduce."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.parallel.sharding import null_ctx  # noqa: E402
from repro_torch.checkpoint.bridge import from_jax_params, to_jax_params  # noqa: E402
from repro_torch.core.config import ModelConfig  # noqa: E402
from repro_torch.core.module import tree_map  # noqa: E402
from repro_torch.models import attention, layers, transformer  # noqa: E402
from repro_torch.models.model import Model, build_model, param_defs  # noqa: E402

JBF16 = jnp.dtype(jnp.bfloat16)
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# fp32: same math, another summation order (the reference embed tests use
# 1e-4).  bf16: the two frameworks round every matmul, bias add, GELU and
# residual add to bf16 independently — one bf16 step is 2^-8..2^-7 of the
# value — and the differences compound through the layers: allow two
# steps of the value plus 2e-2 near zero (measured: at most 1.5 steps).
TOL = {"float32": dict(atol=1e-4, rtol=0), "bfloat16": dict(atol=2e-2, rtol=2**-6)}


def _configs(dtype, param_dtype="float32"):
    jcfg = dataclasses.replace(jax_configs.get_smoke_config("esm2-650m"),
                               dtype=dtype, param_dtype=param_dtype)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _params(jcfg, seed=0):
    """Reference init with biases and norm affines made non-trivial, so the
    comparison exercises every bias and scale."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(seed)))

    def perturb(a):
        if np.all(a == 0):
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if np.all(a == 1):
            return (1 + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree.map(perturb, tree)


def _pair(arr, dtype):
    return torch.from_numpy(arr).to(TDT[dtype]), jnp.asarray(arr, {"float32": jnp.float32,
                                                                   "bfloat16": jnp.bfloat16}[dtype])


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL[dtype])


@pytest.fixture
def impl_env(monkeypatch):
    def set_for(dtype):
        if dtype == "bfloat16":
            monkeypatch.setenv("REPRO_FORCE_IMPL", "pallas_interpret")
    return set_for


# ------------------------------------------------------------------ bridge
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_bridge_round_trips_reference_params_bit_exactly(param_dtype):
    jcfg, _ = _configs("float32", param_dtype)
    tree = jax.tree.map(np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    back = to_jax_params(from_jax_params(tree), bfloat16=JBF16)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert back["head"] == {} == tree["head"]
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_bridge_round_trips_port_params_bit_exactly(param_dtype):
    _, cfg = _configs("float32", param_dtype)
    model = build_model(cfg, device="cpu", seed=3)
    tree = model.params.tree()
    back = from_jax_params(to_jax_params(tree, bfloat16=JBF16))
    pairs = []
    tree_map(lambda p: pairs.append(p), tree)
    tree_map(lambda p: pairs.append(p), back)
    n = len(pairs) // 2
    for a, b in zip(pairs[:n], pairs[n:]):
        assert a.dtype == b.dtype == TDT[param_dtype] and torch.equal(a.detach(), b)
    # materialize is deterministic per seed, and the seed matters
    again = build_model(cfg, device="cpu", seed=3).params.tree()
    other = build_model(cfg, device="cpu", seed=4).params.tree()
    assert torch.equal(again["layers"]["sub0"]["attn"]["wq"], tree["layers"]["sub0"]["attn"]["wq"])
    assert not torch.equal(other["layers"]["sub0"]["attn"]["wq"], tree["layers"]["sub0"]["attn"]["wq"])


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_materialize_scales_in_place_with_the_out_of_place_bits(param_dtype):
    """``materialize`` scales each fp32 draw in place (one temporary of the
    leaf, not two): the same bits as ``(x * std).to(dtype)`` on fan-in,
    normal and stacked leaves."""
    from repro_torch.core.module import P, _leaf_seed, materialize, stacked

    defs = {"w": P((48, 40), ("fsdp", "tp"), fan_in=48),
            "pos": P((30, 16), (None, "fsdp"), init="normal", scale=0.02),
            "layers": {"wo": stacked(P((3, 24, 40), (None, "tp", "fsdp")), 2)}}
    dt = TDT[param_dtype]
    got = materialize(defs, 7, dt, torch.device("cpu"))
    for path, p in (("w", defs["w"]), ("pos", defs["pos"]), ("layers/wo", defs["layers"]["wo"])):
        g = torch.Generator().manual_seed(_leaf_seed(7, tuple(path.split("/"))))
        want = (torch.randn(p.shape, generator=g, dtype=torch.float32) * p.std()).to(dt)
        leaf = got
        for k in path.split("/"):
            leaf = leaf[k]
        assert leaf.dtype == dt and torch.equal(leaf, want), path


def test_param_tree_paths_and_shapes_match_the_reference():
    jcfg, cfg = _configs("float32")
    want = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
    got = tree_map(lambda p: jax.ShapeDtypeStruct(p.shape, jnp.float32), param_defs(cfg))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert [g.shape for g in jax.tree.leaves(got)] == [w.shape for w in jax.tree.leaves(want)]


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_reference(dtype):
    x, jx = _pair(np.random.default_rng(0).standard_normal((2, 24, 4, 64)).astype(np.float32), dtype)
    pos = np.arange(24)
    got = layers.rope(x, torch.from_numpy(pos), 10000.0)
    want = jax_layers.rope(jx, jnp.asarray(pos), 10000.0)
    assert got.dtype == x.dtype
    # rope rounds once to the input dtype from fp32 math in both packages
    tol = dict(atol=1e-5, rtol=0) if dtype == "float32" else dict(atol=1e-2, rtol=2**-7)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_apply_matches_reference(dtype):
    jcfg, cfg = _configs(dtype)
    tree = _params(jcfg)
    p = tree_map(lambda a: a[0], tree["layers"]["sub0"]["ffn"])       # layer 0
    x, jx = _pair(np.random.default_rng(1).standard_normal((2, 24, cfg.d_model)).astype(np.float32), dtype)
    got = layers.mlp_apply(cfg, from_jax_params(p), x)
    want = jax_layers.mlp_apply(jcfg, null_ctx(), p, jx)
    assert got.dtype == x.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_apply_train_mode_matches_reference(dtype, impl_env):
    impl_env(dtype)
    jcfg, cfg = _configs(dtype)
    tree = _params(jcfg)
    p = tree_map(lambda a: a[0], tree["layers"]["sub0"]["attn"])
    x, jx = _pair(0.5 * np.random.default_rng(2).standard_normal((2, 40, cfg.d_model)).astype(np.float32),
                  dtype)
    got, cache = attention.attention_apply(cfg, from_jax_params(p), x)
    want, _ = jax_attention.attention_apply(jcfg, null_ctx(), p, jx, mode="train")
    assert cache is None and got.shape == x.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_stack_matches_reference(dtype, impl_env):
    impl_env(dtype)
    jcfg, cfg = _configs(dtype)
    tree = _params(jcfg)
    x, jx = _pair(np.random.default_rng(3).standard_normal((2, 40, cfg.d_model)).astype(np.float32), dtype)
    got, _, aux = transformer.decoder_stack(cfg, from_jax_params(tree["layers"]), x)
    want, _, jaux = jax_transformer.decoder_stack(jcfg, null_ctx(), tree["layers"], jx, mode="train")
    _close(got, want, dtype)
    assert aux.shape == jaux.shape == () and float(aux) == float(jaux) == 0.0   # dense: no router


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_pool_matches_reference(dtype, impl_env):
    impl_env(dtype)
    jcfg, cfg = _configs(dtype)
    tree = _params(jcfg)
    rng = np.random.default_rng(4)
    toks = rng.integers(1, 30, size=(3, 40)).astype(np.int32)
    lens = np.array([40, 25, 9], np.int32)
    got = Model(cfg, from_jax_params(tree)).embed_pool(torch.from_numpy(toks), torch.from_numpy(lens))
    want = jax_build_model(jcfg).embed_pool(tree, {"tokens": jnp.asarray(toks)}, jnp.asarray(lens))
    assert got.dtype == torch.float32 and got.shape == (3, cfg.d_model)
    # the fp32 mean over positions averages the bf16 rounding differences
    # of the hidden states (measured: 7e-3 at |v| <= 2.9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-4 if dtype == "float32" else 1.5e-2, rtol=0)


def test_unported_architectures_raise():
    """Slice 7's configs build at reduced() size with the reference's param
    tree (encoder, its position table, cross-attention, the projector);
    only a frontend the reference does not know is refused."""
    for name in ("molmim-65m", "whisper-medium", "internvl2-26b"):
        jcfg = jax_configs.get_smoke_config(name)
        model = build_model(ModelConfig(**dataclasses.asdict(jcfg)), device="cpu")
        want = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
        got = tree_map(lambda p: jax.ShapeDtypeStruct(tuple(p.shape), jnp.float32),
                       model.params.tree())
        assert jax.tree.structure(got) == jax.tree.structure(want), name
        assert [g.shape for g in jax.tree.leaves(got)] == [w.shape for w in jax.tree.leaves(want)]
    _, cfg = _configs("float32")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        build_model(dataclasses.replace(cfg, frontend="video_stub"), device="cpu")
