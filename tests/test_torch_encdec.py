"""Encoder-decoder and frontend models against the reference package on
bridged weights: MolMIM-65M (a SMILES seq2seq: the encoder over
``src_tokens`` through the shared embedding), Whisper-medium (an audio
stub: ``enc_embeds`` plus the encoder's position table; learned decoder
positions) and InternVL2-26B (a vision stub: ``img_embeds`` projected in
front of the text), each at ``reduced()`` size on the CPU: configs, param
trees and the bridge; cross ``attention_apply`` in train, prefill and
decode mode; ``_encode``; ``loss_fn`` and every gradient leaf; three AdamW
steps of MolMIM; prefill and decode steps; the SMILES data.

fp32 runs against the reference's default CPU path at 1e-4; bf16 against
the reference with REPRO_FORCE_IMPL=pallas_interpret (its TPU kernels' own
math), within two bf16 steps.

The reference's ``decode_step`` returns a cache without the cross
(``xattn``) entries its prefill stored, so from its second decode step on
its decoder skips cross-attention.  The port keeps the cross cache in
place; the decode comparisons run the reference through ``keep_cross``,
which carries those entries into the cache it returns."""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.core.config import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.core.config import reduced as jax_reduced  # noqa: E402
from repro.core.precision import compute_view as jax_compute_view  # noqa: E402
from repro.data import dataset as jax_dataset  # noqa: E402
from repro.data import tokenizer as jax_tokenizer  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro.parallel.sharding import null_ctx  # noqa: E402
from repro.training import train_step as jax_ts  # noqa: E402
from repro_torch.checkpoint.bridge import from_jax_params, to_jax_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.config import ModelConfig, TrainConfig  # noqa: E402
from repro_torch.core.module import tree_leaves, tree_map  # noqa: E402
from repro_torch.core.precision import compute_view  # noqa: E402
from repro_torch.data import dataset, tokenizer  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.model import Model, build_model, param_defs  # noqa: E402
from repro_torch.training.train_step import init_train_state, make_train_step  # noqa: E402
from test_torch_model import _params  # noqa: E402

NAMES = ["molmim-65m", "whisper-medium", "internvl2-26b"]
JBF16 = jnp.dtype(jnp.bfloat16)


def _configs(name, dtype="float32", **over):
    jcfg = dataclasses.replace(jax_reduced(jax_configs.get_config(name), **over), dtype=dtype)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


@functools.lru_cache(maxsize=None)
def ref_params(name, seed=0):
    """(jcfg, cfg, the reference's perturbed fp32 init): built once a
    process for the tests that share it (they do not modify it)."""
    jcfg, cfg = _configs(name)
    return jcfg, cfg, _params(jcfg, seed=seed)


def keep_cross(jm):
    """The reference model with a ``decode_step`` that carries each layer's
    ``xattn`` cache from the cache it takes into the one it returns (its
    own drops it); ``launch.serve.generate`` and its engine call the
    instance's method."""
    step = jm.decode_step

    def decode_step(params, cache, tokens):
        lg, new = step(params, cache, tokens)
        layers = {s: ({**sub, "xattn": cache["layers"][s]["xattn"]}
                      if "xattn" in cache["layers"][s] else sub)
                  for s, sub in new["layers"].items()}
        return lg, {**new, "layers": layers}

    jm.decode_step = decode_step
    return jm


def batch_for(cfg, B, S, seed, src_len=10, n_img=None):
    """Decoder tokens and what the model takes beside them: ``src_tokens``
    (MolMIM), ``enc_embeds`` of ``num_frontend_tokens`` frames (Whisper),
    ``img_embeds`` (InternVL2), numpy."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)}
    if cfg.frontend == "audio_stub":
        b["enc_embeds"] = rng.standard_normal((B, cfg.num_frontend_tokens, cfg.d_model)) \
            .astype(np.float32)
    elif cfg.frontend == "vision_stub":
        b["img_embeds"] = rng.standard_normal((B, n_img or cfg.num_frontend_tokens, cfg.d_model)) \
            .astype(np.float32)
    else:
        b["src_tokens"] = rng.integers(0, cfg.vocab_size, size=(B, src_len)).astype(np.int32)
    return b


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close_bf16(got, want, steps=2):
    """Within ``steps`` bf16 steps of each row's largest element (each
    framework rounds every product, bias add and residual add on its own)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    top = np.abs(want).max(-1, keepdims=True)
    assert (np.abs(got - want) <= steps * 2.0 ** (np.floor(np.log2(top)) - 7)).all(), \
        np.abs(got - want).max()


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("name", NAMES)
def test_config_fields_param_counts_and_trees_equal_the_reference(name):
    """Every field, the citation included; ``param_count`` at full size and
    at reduced(); the padded vocab; the param paths and shapes at full size
    (nothing materialized) and at reduced()."""
    cfg, jcfg = get_config(name), jax_configs.get_config(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    small, jsmall = _configs(name)[1], _configs(name)[0]
    assert (cfg.param_count(), small.param_count()) == (jcfg.param_count(), jsmall.param_count())
    assert cfg.padded_vocab == {"molmim-65m": 768, "whisper-medium": 51968,
                                "internvl2-26b": 92672}[name]
    assert (small.encoder_layers, small.num_frontend_tokens) == \
        ((2, 0), (2, 16), (0, 16))[NAMES.index(name)]
    for c, jc in ((cfg, jcfg), (small, jsmall)):
        want = jax_build_model(jc).abstract_params()
        got = tree_map(lambda p: jax.ShapeDtypeStruct(p.shape, jnp.float32), param_defs(c))
        assert jax.tree.structure(got) == jax.tree.structure(want)
        assert [g.shape for g in jax.tree.leaves(got)] == [w.shape for w in jax.tree.leaves(want)]
    defs = param_defs(cfg)
    assert ("encoder" in defs) == cfg.is_encoder_decoder
    assert ("projector" in defs) == (cfg.frontend == "vision_stub")
    if cfg.frontend == "audio_stub":      # sized by max_pos, not by the 1 500 frames
        assert defs["encoder"]["pos"].shape == (cfg.max_pos, cfg.d_model)


@pytest.mark.parametrize("name", NAMES)
def test_bridge_round_trips_reference_params_bit_exactly(name):
    """The encoder, its position table, the projector and the decoder's
    cross-attention leaves cross both ways bit for bit."""
    _, cfg, fp32 = ref_params(name)
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    tree = jax.tree.map(lambda a: a.astype(JBF16), fp32)
    port = from_jax_params(tree)
    back = to_jax_params(port, bfloat16=JBF16)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    assert build_model(cfg, device="cpu").params.tree().keys() == port.keys()
    if cfg.is_encoder_decoder:
        assert {"xattn", "norm_x"} <= set(port["layers"]["sub0"])
        assert set(port["encoder"]) >= {"layers", "final_norm"}
        assert ("pos" in port["encoder"]) == (cfg.frontend == "audio_stub")
    else:
        assert set(port["projector"]) == {"w", "b"}


# ------------------------------------------------------------------ cross-attention
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_apply_matches_reference(dtype, monkeypatch):
    """Train and prefill over an encoder output of T = 21 rows (S = 13
    queries: never causal, no RoPE), the write-once {k, v, len} cache, then
    a decode step over it; reduced MolMIM (RoPE on its self-attention)."""
    if dtype == "bfloat16":
        monkeypatch.setenv("REPRO_FORCE_IMPL", "pallas_interpret")
    jcfg, cfg = _configs("molmim-65m", dtype)
    tree = ref_params("molmim-65m")[2]
    p = tree["layers"]["sub0"]["xattn"]
    jp = jax.tree.map(lambda a: a[0], p)
    tp = from_jax_params(jp)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 21, cfg.d_model)).astype(np.float32)
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]

    def close(got, want):
        if dtype == "float32":
            np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                       atol=1e-4, rtol=0)
        else:
            _close_bf16(got.float().numpy(), want)

    tx, tenc = torch.from_numpy(x).to(tdt), torch.from_numpy(enc).to(tdt)
    jx, jenc = jnp.asarray(x, jdt), jnp.asarray(enc, jdt)
    for mode in ("train", "prefill"):
        got, cache = attention.attention_apply(cfg, tp, tx, mode=mode, cross_kv=tenc)
        want, _ = jax_attention.attention_apply(jcfg, null_ctx(), jp, jx, mode=mode, cross_kv=jenc)
        close(got, want)
    _, ck, cv = jax_attention._project_qkv(jcfg, jp, jx, kv_src=jenc)
    close(cache["k"], ck)
    close(cache["v"], cv)
    assert cache["len"].tolist() == [21, 21] and cache["k"].shape == (2, 21, cfg.num_kv_heads,
                                                                      cfg.resolved_head_dim)
    # decode: one query row a slot over the cache's first len rows (slot 1 at 15)
    cache["len"] = torch.tensor([21, 15], dtype=torch.int32)
    jcache = {"k": ck, "v": cv, "len": jnp.asarray([21, 15], jnp.int32)}
    got, same = attention.attention_apply(cfg, tp, tx[:, :1], mode="decode", cache=cache)
    want, _ = jax_attention.attention_apply(jcfg, null_ctx(), jp, jx[:, :1], mode="decode",
                                            cache=jcache)
    close(got, want)
    assert same is cache
    with pytest.raises(ValueError, match="decode step reads the cross cache"):
        attention.attention_apply(cfg, tp, tx, mode="chunk", cross_kv=tenc)


# ------------------------------------------------------------------ the encoder
@pytest.mark.parametrize("name", ["molmim-65m", "whisper-medium"])
def test_encode_matches_reference(name):
    """From ``src_tokens`` through the shared embedding (MolMIM) and from
    ``enc_embeds`` plus the first T_enc rows of the encoder's position
    table (Whisper); bidirectional, then the encoder's final norm."""
    jcfg, cfg, tree = ref_params(name)
    batch = batch_for(cfg, 2, 6, seed=3)
    got = Model(cfg, from_jax_params(tree))._encode(from_jax_params(tree), _t(batch))
    want = jax_build_model(jcfg)._encode(tree, _j(batch))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4, rtol=0)
    if name == "whisper-medium":         # the table's rows are in: without them it differs
        nopos = from_jax_params(tree)
        nopos["encoder"]["pos"] = torch.zeros_like(nopos["encoder"]["pos"])
        other = Model(cfg, nopos)._encode(nopos, _t(batch))
        assert (other - got).abs().max() > 1e-2


# ------------------------------------------------------------------ loss and gradients
@pytest.mark.parametrize("name", NAMES)
def test_loss_and_every_grad_leaf_match_reference(name):
    """fp32; every leaf within 1e-4 of its largest |gradient|.  A key bias
    where no RoPE follows it (cross-attention's; every one of Whisper's):
    it shifts every score of a query alike, so its exact gradient is 0, and
    both sides hold rounding noise below 1e-6 of the largest gradient.  InternVL2: the 16 image rows are outside the
    loss (the token count is the text's), yet the projector trains."""
    jcfg, cfg, tree = ref_params(name)
    batch = batch_for(cfg, 2, 12, seed=1)
    jm = jax_build_model(jcfg)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(jax_compute_view(jm.policy, p), _j(batch)), has_aux=True))(tree)
    model = Model(cfg, from_jax_params(tree))
    params = model.params.tree()
    loss, metrics = model.loss_fn(compute_view(model.policy, params), _t(batch))
    grads = torch.autograd.grad(loss, tree_leaves(params))
    assert float(metrics["tokens"]) == float(jmet["tokens"]) == 2 * 11
    assert abs(loss.item() - float(jloss)) <= 1e-4
    want = [np.asarray(w) for w in jax.tree.leaves(jgrads)]
    assert len(grads) == len(want)
    top = max(np.abs(w).max() for w in want)
    leaves = tree_leaves(params)
    stacks = [params["layers"]] + ([params["encoder"]["layers"]] if "encoder" in params else [])
    xbk = {id(sub[kind]["bk"]) for st in stacks for sub in st.values() for kind in sub
           if kind == "xattn" or (kind == "attn" and not cfg.use_rope)}
    for p, g, w in zip(leaves, grads, want):
        if id(p) in xbk:
            assert max(np.abs(g.numpy()).max(), np.abs(w).max()) <= 1e-6 * top
            continue
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * np.abs(w).max(), rtol=0)
    if name == "internvl2-26b":
        proj = next(g for g, p in zip(grads, leaves) if p is params["projector"]["w"])
        assert proj.abs().max() > 0


def test_molmim_three_adamw_steps_match_reference():
    jcfg, cfg, tree = ref_params("molmim-65m")
    kw = dict(global_batch=4, seq_len=16, learning_rate=1e-3, warmup_steps=1, decay_steps=1,
              total_steps=3, weight_decay=0.1)
    jstep = jax.jit(jax_ts.make_train_step(jax_build_model(jcfg), JaxTrainConfig(**kw)))
    jstate = jax_ts.TrainState(tree, jax_adamw.init_state(tree))
    model = Model(cfg, from_jax_params(tree))
    state, step = init_train_state(model), make_train_step(model, TrainConfig(**kw))
    for i in range(3):
        b = batch_for(cfg, 4, 16, seed=10 + i, src_len=16)
        jstate, jm = jstep(jstate, _j(b))
        state, m = step(state, _t(b))
        assert abs(m["loss"].item() - float(jm["loss"])) <= 1e-5
        assert abs(m["grad_norm"].item() - float(jm["grad_norm"])) <= 1e-4 * float(jm["grad_norm"])
    # Adam divides by sqrt(v): grads that differ in the last bits move a
    # near-zero-gradient weight (the cross key bias's) by up to ~lr
    want = jax.tree.leaves(jstate.params) + jax.tree.leaves(jstate.opt.mu) \
        + jax.tree.leaves(jstate.opt.nu)
    got = tree_leaves(state.params) + tree_leaves(state.opt.mu) + tree_leaves(state.opt.nu)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-3, rtol=0)


# ------------------------------------------------------------------ prefill and decode
@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_steps_match_reference(name):
    """``prefill`` (the cross K/V stored once; the image rows in front of the
    text and in the cache position), then lockstep decode steps and steps at
    per-slot positions, against the reference's through ``keep_cross``.
    The reference's own decode step returns no ``xattn`` entry: its next
    step would have no cross-attention."""
    jcfg, cfg, tree = ref_params(name)
    jm = jax_build_model(jcfg)
    model = Model(cfg, from_jax_params(tree))
    params = model.params.tree()
    batch = batch_for(cfg, 3, 9, seed=4)
    max_len = 48
    lg, cache = model.prefill(params, _t(batch), max_len)
    jlg, jcache = jax.jit(lambda p, b: jm.prefill(p, b, max_len))(tree, _j(batch))
    if cfg.is_encoder_decoder:
        drop = jax.eval_shape(jm.decode_step, tree, jcache, jnp.zeros((3, 1), jnp.int32))[1]
        assert "xattn" in jcache["layers"]["sub0"] and "xattn" not in drop["layers"]["sub0"]
    keep_cross(jm)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4, rtol=0)
    n_front = cfg.num_frontend_tokens if cfg.frontend == "vision_stub" else 0
    assert cache["pos"] == int(jcache["pos"]) == 9 + n_front
    if cfg.is_encoder_decoder:
        x = cache["layers"]["sub0"]["xattn"]
        T = batch["src_tokens"].shape[1] if "src_tokens" in batch else cfg.num_frontend_tokens
        assert x["k"].shape[:3] == (cfg.num_layers, 3, T)
        assert x["len"].tolist() == [[T] * 3] * cfg.num_layers
    rng = np.random.default_rng(5)
    jdecode = jax.jit(jm.decode_step)
    for t in range(5):
        if t == 3:        # per-slot positions, as the serving engine keeps them
            pos = np.array([cache["pos"] + 3, cache["pos"] - 4, cache["pos"] + 1], np.int32)
            cache["pos"], jcache["pos"] = torch.from_numpy(pos.copy()), jnp.asarray(pos)
        nxt = rng.integers(0, cfg.vocab_size, size=(3, 1)).astype(np.int32)
        lg, cache = model.decode_step(params, cache, torch.from_numpy(nxt))
        jlg, jcache = jdecode(tree, jcache, jnp.asarray(nxt))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4, rtol=0,
                                   err_msg=f"decode step {t}")


# ------------------------------------------------------------------ data
def test_tokenizers_and_smiles_corpus_match_reference():
    seqs = dataset.synthetic_smiles_sequences(40, seed=3)
    assert seqs == jax_dataset.synthetic_smiles_sequences(40, seed=3)
    for ours, theirs in ((tokenizer.SmilesTokenizer(), jax_tokenizer.SmilesTokenizer()),
                         (tokenizer.ByteTokenizer(), jax_tokenizer.ByteTokenizer())):
        assert ours.vocab == theirs.vocab and ours.vocab_size == theirs.vocab_size
        text = seqs + ["C(=O)[N+]#x\\/@%", "hello, world ~"]
        assert [ours.encode(t) for t in text] == [theirs.encode(t) for t in text]
        assert np.array_equal(ours.encode_batch(text, 24), theirs.encode_batch(text, 24))
        assert ours.decode(ours.encode(seqs[0])) == theirs.decode(theirs.encode(seqs[0]))
    # every character of the corpus is in the SMILES alphabet, within MolMIM's vocab
    ids = [i for s in seqs for i in tokenizer.SmilesTokenizer().encode(s)]
    assert 3 not in ids and max(ids) < get_config("molmim-65m").vocab_size
