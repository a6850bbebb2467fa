"""The port's LoRA module against the reference's ``training/lora.py`` on
bridged weights and bridged adapters (never two inits): the target paths,
the merge, the zero-init identity, the LoRA loss with its gradients for A,
B and alpha, five AdamW steps over the adapter tree (alpha included, as
the reference trains it) and the trainable count.

fp32 runs against the reference's default CPU path; bf16 against the
reference with REPRO_FORCE_IMPL=pallas_interpret, as in the model tests."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.core.config import ModelConfig as JaxModelConfig  # noqa: E402
from repro.core.config import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.training import lora as jax_lora  # noqa: E402
from repro_torch.checkpoint.bridge import from_jax_params  # noqa: E402
from repro_torch.core.config import ModelConfig, TrainConfig  # noqa: E402
from repro_torch.core.module import tree_leaves  # noqa: E402
from repro_torch.data.pipeline import mlm_corrupt  # noqa: E402
from repro_torch.data.tokenizer import ProteinTokenizer  # noqa: E402
from repro_torch.models.model import Model, build_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.training import lora  # noqa: E402
from test_torch_model import _params  # noqa: E402

ARCHS = ("esm2-650m", "qwen2-7b", "llama4-scout-17b-a16e")


def _configs(arch, dtype="float32"):
    jcfg = dataclasses.replace(jax_configs.get_smoke_config(arch), dtype=dtype,
                               param_dtype="float32")
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _adapters(tree, rank=4, seed=3, b_scale=0.02):
    """Reference adapters with a nonzero B (numpy-seeded), so A, B and
    alpha all get a gradient; numpy leaves for both packages."""
    rng = np.random.default_rng(seed)
    ad = _np_tree(jax_lora.init_adapters(tree, rank=rank, key=jax.random.PRNGKey(2)))
    for ab in ad["weights"].values():
        ab["B"] = (b_scale * rng.standard_normal(ab["B"].shape)).astype(np.float32)
    return ad


def _batch(cfg, seed=1, B=4, S=24):
    rng = np.random.default_rng(seed)
    toks = rng.integers(5, min(cfg.vocab_size, 25), size=(B, S)).astype(np.int32)
    toks[:, 0], toks[:, -1] = 1, 2
    toks[1, S - 5:] = 0
    if cfg.objective == "mlm":
        return mlm_corrupt(toks, ProteinTokenizer(), rng, 0.3)
    return {"tokens": toks, "loss_mask": (toks != 0).astype(np.float32)}


def _bf16_bits(a):
    return np.asarray(a, np.float32).view(np.uint32) >> 16


# ------------------------------------------------------------ targets, merge
@pytest.mark.parametrize("arch", ARCHS)
def test_target_paths_match_reference(arch):
    jcfg, cfg = _configs(arch)
    jtree = jax.eval_shape(lambda: jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    tree = build_model(cfg, device="cpu").params.tree()
    wide = ("wq", "wk", "wv", "wo", "w_in", "w_out", "w_gate")
    for targets in (lora.DEFAULT_TARGETS, wide):
        want = jax_lora.target_paths(jtree, targets)
        assert lora.target_paths(tree, targets) == want and want
    assert lora.DEFAULT_TARGETS == jax_lora.DEFAULT_TARGETS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merged_params_match_reference(dtype):
    jcfg, _ = _configs("esm2-650m")
    tree = _np_tree(_params(jcfg))
    if dtype == "bfloat16":
        tree = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), tree)
    ad = _adapters(tree, b_scale=0.5)
    want = jax.tree.map(np.asarray, jax_lora.merged_params(tree, ad))
    base = from_jax_params(tree)
    got = lora.merged_params(base, from_jax_params(ad))
    paths = {"/".join(p) for p in lora.target_paths(base)}
    flat_got, flat_want = dict(lora._walk(got)), dict(lora._walk(want))
    assert flat_got.keys() == flat_want.keys()
    for path, g in flat_got.items():
        w = flat_want[path]
        if "/".join(path) not in paths:
            assert g is dict(lora._walk(base))[path]      # the base's own tensor
            continue
        assert g.dtype == base["embed"]["tok"].dtype
        if dtype == "float32":
            # the same fp32 sum of 4 products in another order
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6 * np.abs(w).max())
        else:   # the fp32 sums round to the same or the neighbouring bf16 value
            gb, wb = _bf16_bits(g.float().numpy()), _bf16_bits(np.asarray(w, np.float32))
            assert np.abs(gb.astype(np.int64) - wb.astype(np.int64)).max() <= 1


def test_zero_init_is_an_exact_identity():
    jcfg, cfg = _configs("esm2-650m")
    tree = _params(jcfg)
    model = Model(cfg, from_jax_params(tree))
    base = model.params.tree()
    ad = lora.init_adapters(base, rank=4, generator=torch.Generator().manual_seed(0))
    merged = lora.merged_params(base, ad)
    for path in lora.target_paths(base):
        a, b = dict(lora._walk(merged))[path], dict(lora._walk(base))[path]
        assert torch.equal(a, b)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    l0, _ = model.loss_fn(base, batch)
    l1, _ = lora.make_lora_loss(model, base)(ad, batch)
    assert l0.item() == l1.item()
    # and the reference's zero-init adapters, bridged, give the same bits
    jad = from_jax_params(_np_tree(jax_lora.init_adapters(tree, rank=4, key=jax.random.PRNGKey(2))))
    assert lora.make_lora_loss(model, base)(jad, batch)[0].item() == l0.item()


# ------------------------------------------------------------ loss + grads
@pytest.mark.parametrize("arch,dtype", [("esm2-650m", "float32"), ("qwen2-7b", "float32"),
                                        ("esm2-650m", "bfloat16")])
def test_lora_loss_and_adapter_grads_match_reference(arch, dtype, monkeypatch):
    if dtype == "bfloat16":
        monkeypatch.setenv("REPRO_FORCE_IMPL", "pallas_interpret")
    jcfg, cfg = _configs(arch, dtype)
    tree = _params(jcfg)
    ad = _adapters(_np_tree(tree))
    batch = _batch(cfg)
    jloss_fn = jax_lora.make_lora_loss(jax_build_model(jcfg), tree)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(
        ad, {k: jnp.asarray(v) for k, v in batch.items()})
    model = Model(cfg, from_jax_params(tree))
    base = model.params.tree()
    tad = from_jax_params(ad)
    leaves = tree_leaves(tad)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = lora.make_lora_loss(model, base)(tad, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    want = [np.asarray(w, np.float32) for w in jax.tree.leaves(jgrads)]
    assert len(grads) == len(want) == 1 + 2 * len(lora.target_paths(base))
    assert grads[0].shape == () and float(want[0]) != 0.0           # alpha's
    assert all(p.grad is None for p in tree_leaves(base))           # the base is frozen
    if dtype == "float32":
        # the same fp32 math in another summation order
        assert loss.item() == pytest.approx(float(jloss), rel=1e-4)
        for g, w in zip(grads, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max())
        return
    # bf16: each framework rounds every matmul, bias add, GELU and residual
    # to bf16 on its own, forward and backward.  The loss within two bf16
    # steps (measured: 0.02); the gradients within 3% of each leaf's
    # largest element, about twice the largest reading (measured: 0.67% to
    # 1.44% over the five leaves, 3.7 bf16 steps; cosine >= 0.99990)
    assert abs(loss.item() - float(jloss)) <= 2 * 2**-8 * abs(float(jloss))
    for g, w in zip(grads, want):
        g = g.numpy()
        assert np.abs(g - w).max() <= 0.03 * np.abs(w).max()
        assert (g * w).sum() / np.linalg.norm(g) / np.linalg.norm(w) >= 0.999


# ------------------------------------------------------------ training
def _reference_setup():
    """``tests/test_lora.py``'s setup: its model, batch and adapters."""
    jcfg = JaxModelConfig(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
                          num_kv_heads=2, d_ff=128, vocab_size=64, dtype="float32")
    jmodel = jax_build_model(jcfg)
    tree = jmodel.init(jax.random.PRNGKey(0))
    batch = {"tokens": jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0, 64)}
    ad = jax_lora.init_adapters(tree, rank=4, key=jax.random.PRNGKey(2))
    return jcfg, jmodel, tree, batch, ad


def test_five_adamw_steps_match_reference_alpha_included():
    jcfg, jmodel, tree, jbatch, jad = _reference_setup()
    lr = 5e-3
    jtc, tc = JaxTrainConfig(learning_rate=lr, weight_decay=0.0), TrainConfig(learning_rate=lr,
                                                                                weight_decay=0.0)
    jloss_fn = jax_lora.make_lora_loss(jmodel, tree)

    @jax.jit
    def jstep(ad, st):
        (loss, _), g = jax.value_and_grad(jloss_fn, has_aux=True)(ad, jbatch)
        ad, st = jax_adamw.apply_updates(ad, g, st, jnp.float32(lr), jtc)
        return ad, st, loss

    model = Model(ModelConfig(**dataclasses.asdict(jcfg)), from_jax_params(_np_tree(tree)))
    base = model.params.tree()
    before = [p.detach().clone() for p in tree_leaves(base)]
    ad = from_jax_params(_np_tree(jad))
    leaves = tree_leaves(ad)
    loss_fn = lora.make_lora_loss(model, base)
    batch = {"tokens": torch.from_numpy(np.array(jbatch["tokens"]))}
    st, jst = adamw.init_state(ad), jax_adamw.init_state(jad)
    for _ in range(5):
        jad, jst, jloss = jstep(jad, jst)
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = loss_fn(ad, batch)
        grads = list(torch.autograd.grad(loss, leaves))
        st = adamw.apply_updates(ad, grads, st, torch.tensor(lr), tc)
        assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
    assert int(st.step) == int(jst.step) == 5
    alpha = ad["alpha"].item()
    assert alpha != 16.0 and alpha == pytest.approx(float(jad["alpha"]), abs=1e-6)
    # adapters, first and second moments, each leaf relative to its own
    # scale: nu is ~1e-5 after five steps, so an absolute bound would pass
    # any second moment (measured: elementwise at most 7.3e-4 relative,
    # 1.3e-5 of the leaf's max)
    want = jax.tree.leaves(jad) + jax.tree.leaves(jst.mu) + jax.tree.leaves(jst.nu)
    got = leaves + tree_leaves(st.mu) + tree_leaves(st.nu)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-3, atol=1e-3 * np.abs(w).max())
    for p, b in zip(tree_leaves(base), before):      # the base is bit-unchanged
        assert torch.equal(p.detach(), b)


def test_count_trainable_matches_reference():
    jcfg, _, tree, _, jad = _reference_setup()
    ad = from_jax_params(_np_tree(jad))
    assert lora.count_trainable(ad) == jax_lora.count_trainable(jad) == 2 * (64 * 4 + 4 * 64 + 64 * 4 + 4 * 32)
    n_base = sum(x.size for x in jax.tree.leaves(tree))
    assert lora.count_trainable(ad) < 0.1 * n_base
    ad2 = lora.init_adapters(from_jax_params(_np_tree(tree)), rank=4,
                             generator=torch.Generator().manual_seed(1))
    assert lora.count_trainable(ad2) == lora.count_trainable(ad)
    assert ad2["alpha"].dtype == torch.float32 and ad2["alpha"].shape == ()
    for path, ab in ad2["weights"].items():
        assert ab["A"].shape == ad["weights"][path]["A"].shape and not ab["B"].any()
