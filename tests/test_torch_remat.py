"""Remat in the training stack (``ParallelConfig.remat_policy``): each unit
of the stack under ``none``, ``block``, ``dots`` or ``full``, on reduced
ESM-2, a Scout-like MoE (the router's aux vector), Mamba2, Jamba's hybrid
unit and MolMIM's encoder-decoder.

Every kernel of the stack is deterministic, so every policy must give
``none``'s loss and gradients bit for bit.  On ESM-2, ``none`` and
``dots`` are also held against ``jax.grad`` of the reference built with
the same ``ParallelConfig``, at the fp32 tolerances of the training tests
(``block``, both packages' default, is held for every model by the
existing ones).  The bytes saved for the backward (through
``saved_tensors_hooks``) show that ``block`` drops the units'
activations, and ``full`` keeps what ``none`` keeps."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.core.config import ParallelConfig as JaxParallelConfig  # noqa: E402
from repro.core.config import reduced as jax_reduced  # noqa: E402
from repro.core.precision import compute_view as jax_compute_view  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch.checkpoint.bridge import from_jax_params  # noqa: E402
from repro_torch.core.config import ModelConfig, ParallelConfig, TrainConfig  # noqa: E402
from repro_torch.core.module import tree_leaves  # noqa: E402
from repro_torch.core.precision import compute_view  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.model import Model, build_model  # noqa: E402
from repro_torch.training import loop  # noqa: E402
from repro_torch.training.train_step import init_train_state  # noqa: E402
from test_torch_model import _params  # noqa: E402

POLICIES = ("none", "block", "dots", "full")
MODELS = ("esm2-650m", "llama4-scout-17b-a16e", "mamba2-2.7b", "jamba-1.5-large-398b",
          "molmim-65m")
_CASES = {}


def _jcfg(name):
    return dataclasses.replace(jax_reduced(jax_configs.get_config(name)), dtype="float32",
                               param_dtype="float32")


def _batch(cfg):
    """A numpy batch for reduced ``cfg``: tokens, MLM targets and mask, an
    encoder-decoder's source tokens."""
    rng = np.random.default_rng(1)
    toks = rng.integers(5, min(cfg.vocab_size, 500), size=(2, 20)).astype(np.int32)
    batch = {"tokens": toks}
    if cfg.objective == "mlm":
        batch.update(targets=toks, loss_mask=(rng.random(toks.shape) < 0.5).astype(np.float32))
    if cfg.is_encoder_decoder:
        batch["src_tokens"] = rng.integers(5, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    return batch


def _case(name):
    """(reference config, its perturbed fp32 tree, a numpy batch) of reduced
    ``name``, built once a process."""
    if name not in _CASES:
        jcfg = _jcfg(name)
        _CASES[name] = (jcfg, _params(jcfg), _batch(jcfg))
    return _CASES[name]


def _port(name, policy, dtype=None, ref=False):
    """The port's reduced ``name`` at ``policy``: with ``ref``, on the
    reference's tree (``_case``), else on its own seeded weights (the
    policies are compared with one another only)."""
    pc = ParallelConfig(remat_policy=policy)
    if ref:
        jcfg, tree, batch = _case(name)
        return Model(ModelConfig(**dataclasses.asdict(jcfg)), from_jax_params(tree), pc), batch
    cfg = ModelConfig(**dataclasses.asdict(_jcfg(name)))
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return build_model(cfg, pc, device="cpu", seed=0), _batch(cfg)


def _loss_grads(model, batch):
    """(loss, every gradient leaf, bytes saved for the backward: the distinct
    storages that autograd's saved-tensor hooks see)."""
    params = model.params.tree()
    saved = {}

    def pack(t):
        s = t.untyped_storage()
        saved[s.data_ptr()] = s.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = model.loss_fn(compute_view(model.policy, params),
                                {k: torch.from_numpy(v) for k, v in batch.items()})
    return loss, torch.autograd.grad(loss, tree_leaves(params)), sum(saved.values())


@pytest.mark.parametrize("name,dtype", [(m, "float32") for m in MODELS]
                         + [("esm2-650m", "bfloat16"), ("mamba2-2.7b", "bfloat16")])
def test_every_policy_equals_none_bit_for_bit(name, dtype, monkeypatch):
    """Loss and every gradient leaf at block, dots and full equal none's
    (``torch.equal``); each unit's layers run once without remat and twice
    (forward, then again in the backward) under block and dots; block
    saves far fewer bytes, full exactly none's."""
    calls = [0]
    apply = T._apply_sublayer

    def counted(*a, **kw):
        calls[0] += 1
        return apply(*a, **kw)

    monkeypatch.setattr(T, "_apply_sublayer", counted)
    got = {}
    for policy in POLICIES:
        model, batch = _port(name, policy, dtype)
        calls[0] = 0
        got[policy] = _loss_grads(model, batch) + (calls[0],)
    loss0, grads0, saved0, calls0 = got["none"]
    cfg = model.cfg
    layers = cfg.num_layers + (cfg.encoder_layers if cfg.is_encoder_decoder else 0)
    assert calls0 == layers
    for policy in POLICIES[1:]:
        loss, grads, saved, n = got[policy]
        assert torch.equal(loss, loss0), policy
        assert len(grads) == len(grads0)
        assert all(torch.equal(g, w) for g, w in zip(grads, grads0)), policy
        assert n == (layers if policy == "full" else 2 * layers), policy
    assert got["full"][2] == saved0
    # the units' activations are gone: what stays is outside the stack
    # (embedding, final norm, head and loss); measured 1-11% of none's
    assert got["block"][2] < 0.2 * saved0


# block is both packages' default, so every model's existing loss-and-
# gradient test against the reference holds it (test_torch_train.py,
# test_torch_moe_train.py, test_torch_ssm.py -- reduced Mamba2 and Jamba --
# and test_torch_encdec.py); here none and dots, each against the
# reference built at the same one, on ESM-2 (the cheapest reference
# compile).  full runs unwrapped, none's path, and the port's policies are
# bit-equal to one another (above).
REF_CASES = [("esm2-650m", p) for p in ("none", "dots")]


@pytest.mark.parametrize("name,policy", REF_CASES)
def test_each_policy_matches_the_reference_at_the_same_policy(name, policy):
    """fp32 both sides, the training tests' tolerances: the loss within
    1e-5 and each leaf within 1e-4 of its largest magnitude."""
    jcfg, tree, batch = _case(name)
    jm = jax_build_model(jcfg, JaxParallelConfig(remat_policy=policy))
    assert jm.ctx.pc.remat_policy == policy
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(jax_compute_view(jm.policy, p),
                             {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True))(tree)
    model, _ = _port(name, policy, ref=True)
    loss, grads, _ = _loss_grads(model, batch)
    assert abs(loss.item() - float(jloss)) <= 1e-5
    want = [np.asarray(w) for w in jax.tree.leaves(jgrads)]
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        g = g.numpy()
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max(), rtol=0)


def test_nothing_is_wrapped_without_a_gradient(monkeypatch):
    """Under ``no_grad`` (embedding, prefill, every serving path) no unit
    goes through ``torch.utils.checkpoint``; with autograd on, each unit
    of each stack goes through it once."""
    import torch.utils.checkpoint as tc

    calls = [0]
    ckpt = tc.checkpoint

    def counted(*a, **kw):
        calls[0] += 1
        return ckpt(*a, **kw)

    monkeypatch.setattr(tc, "checkpoint", counted)
    model, batch = _port("molmim-65m", "block")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        model.loss_fn(model.params.tree(), tb)
        model.prefill(model.params.tree(), tb, 32)
    esm, esm_batch = _port("esm2-650m", "dots")
    with torch.no_grad():
        esm.embed_pool(torch.from_numpy(esm_batch["tokens"]), torch.tensor([20, 15]))
    assert calls[0] == 0
    model.loss_fn(model.params.tree(), tb)
    cfg = model.cfg
    assert calls[0] == T.num_units(cfg) + cfg.encoder_layers


def test_the_default_policy_is_the_references_and_rules_the_trainer():
    assert ParallelConfig().remat_policy == JaxParallelConfig().remat_policy == "block"
    with pytest.raises(ValueError, match="remat_policy"):
        ParallelConfig(remat_policy="selective")
    pc = ParallelConfig(remat_policy="dots", optimizer_state_dtype="bfloat16")
    model = build_model(ModelConfig(**dataclasses.asdict(_jcfg("esm2-650m"))), pc, device="cpu")
    assert model.pc is pc
    # one ParallelConfig rules both the moments' dtype and remat
    assert init_train_state(model).opt.mu["embed"]["tok"].dtype == torch.bfloat16
    tc = TrainConfig(global_batch=2, seq_len=8, total_steps=1)
    assert loop.Trainer(model, tc, verbose=False).pc is pc
    with pytest.raises(ValueError, match="differs from the model's"):
        loop.Trainer(model, tc, pc=ParallelConfig(), verbose=False)

