"""Serving the encoder-decoder and frontend models against the reference
package on bridged weights, at ``reduced()`` size on the CPU: the static
batch of ``launch.serve.generate`` (MolMIM greedy and seeded sampled,
Whisper with an audio a row) and ``LLM.generate`` with one ``extra_batch``
for all requests (Whisper, and InternVL2 with its image and text-only)
over the dense and the paged cache, token for token; the engine's
refusals.

The reference's ``decode_step`` drops the cross cache it is given
(``test_torch_encdec.py``), so the reference runs through ``keep_cross``,
which carries it into the next step: without it, the reference's dense
engine raises at the first admission after a decode step.  Tokens must be
equal; log-probabilities within 1e-4 (fp32 logits of the same products
summed in another order)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.launch import serve as jax_serve  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving.api import LLM as JaxLLM  # noqa: E402
from repro.serving.sampling import SamplingParams as JaxSP  # noqa: E402
from repro_torch.checkpoint.bridge import from_jax_params  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.dataset import synthetic_smiles_sequences  # noqa: E402
from repro_torch.data.tokenizer import SmilesTokenizer  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models.model import Model, build_model  # noqa: E402
from repro_torch.serving.api import LLM  # noqa: E402
from repro_torch.serving.sampling import SamplingParams  # noqa: E402
from test_torch_encdec import batch_for, keep_cross, ref_params  # noqa: E402


def _models(name):
    jcfg, cfg, tree = ref_params(name)
    return keep_cross(jax_build_model(jcfg)), tree, Model(cfg, from_jax_params(tree))


def _prompts(n, vocab, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(L)).tolist() for L in rng.integers(lo, hi, size=n)]


def _mix(SP, n):
    """Greedy and seeded rows, log-probabilities on some."""
    base = [SP(max_new=6),
            SP(temperature=0.8, top_k=20, top_p=0.9, seed=3, max_new=6, logprobs=True),
            SP(temperature=1.1, seed=2**31 + 5, max_new=5, logprobs=True)]
    return (base * n)[:n]


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.tokens == w.tokens, (g.index, g.tokens, w.tokens)
        assert g.finish_reason == w.finish_reason
        if w.logprobs is not None:
            np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-4, rtol=0)


# ------------------------------------------------------------------ launch.serve.generate
def test_molmim_static_generate_matches_reference():
    """24-token SMILES sources, 8-token prompts (their first tokens), 10 new
    tokens: greedy, then sampled with the per-row seeds ``arange(B) + 7``."""
    jm, tree, model = _models("molmim-65m")
    tok = SmilesTokenizer()
    src = tok.encode_batch(synthetic_smiles_sequences(4, seed=1), 24)
    batch = {"tokens": src[:, :8], "src_tokens": src}
    for kw in (dict(), dict(temperature=0.9, top_k=30, top_p=0.95, seed=7)):
        got, _ = generate(model, None, batch, max_len=24, steps=10, **kw)
        want, _ = jax_serve.generate(jm, tree, {k: jnp.asarray(v) for k, v in batch.items()},
                                     max_len=24, steps=10, **kw)
        assert got.dtype == torch.int32 and got.shape == (4, 10)
        assert np.array_equal(got.numpy(), np.asarray(want)), kw


def test_whisper_static_generate_with_an_audio_a_row_matches_reference():
    jm, tree, model = _models("whisper-medium")
    batch = batch_for(model.cfg, 3, 5, seed=2)            # 3 distinct audios of 16 frames
    got, _ = generate(model, model.params.tree(), batch, max_len=20, steps=8, temperature=0.7,
                      seed=11)
    want, _ = jax_serve.generate(jm, tree, {k: jnp.asarray(v) for k, v in batch.items()},
                                 max_len=20, steps=8, temperature=0.7, seed=11)
    assert np.array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------------ LLM.generate
def test_whisper_generate_over_dense_and_paged_caches_matches_reference():
    """One audio for every request (the engine's ``extra_batch``, re-encoded
    at each admission): 7 prompts of 3-10 tokens on 3 slots, so later
    admissions find slots whose cross cache an earlier request filled; the
    paged pool frees every page."""
    jm, tree, model = _models("whisper-medium")
    audio = batch_for(model.cfg, 1, 1, seed=4)["enc_embeds"]
    prompts = _prompts(7, model.cfg.vocab_size, 3, 11, seed=5)
    out = {}
    for layout in ("dense", "paged"):
        kw = dict(slots=3, max_len=32, cache_layout=layout, page_size=8)
        llm = LLM(model, extra_batch={"enc_embeds": audio}, **kw)
        out[layout] = llm.generate(prompts, _mix(SamplingParams, 7))
        if layout == "paged":
            assert llm.engine.alloc.free_pages == llm.engine.alloc.num_pages - 1
    want = JaxLLM(jm, tree, extra_batch={"enc_embeds": jnp.asarray(audio)}, slots=3, max_len=32) \
        .generate(prompts, _mix(JaxSP, 7))
    _same(out["dense"], want)
    _same(out["paged"], want)


def test_internvl2_generate_with_an_image_and_text_only_matches_reference():
    """With one image (16 rows in front of every prompt, which count toward
    max_len) over the dense cache against the reference and over the paged
    cache against the dense one (the reference's paged engine gives its
    dense tokens), then text-only: no image rows, and prefix caching
    allowed again."""
    jm, tree, model = _models("internvl2-26b")
    img = batch_for(model.cfg, 1, 1, seed=6)["img_embeds"]
    prompts = _prompts(6, model.cfg.vocab_size, 2, 12, seed=7)
    kw = dict(slots=3, max_len=40, page_size=8)
    got = {}
    for layout in ("dense", "paged"):
        llm = LLM(model, extra_batch={"img_embeds": img}, cache_layout=layout, **kw)
        got[layout] = llm.generate(prompts, _mix(SamplingParams, 6))
        assert llm.engine.n_front == 16
    want = JaxLLM(jm, tree, extra_batch={"img_embeds": jnp.asarray(img)}, **kw) \
        .generate(prompts, _mix(JaxSP, 6))
    _same(got["dense"], want)
    _same(got["paged"], want)
    text = LLM(model, cache_layout="paged", prefix_cache=True, prefill_chunk=4, **kw)
    got = text.generate(prompts, _mix(SamplingParams, 6))
    want = JaxLLM(jm, tree, cache_layout="paged", prefix_cache=True, prefill_chunk=4, **kw) \
        .generate(prompts, _mix(JaxSP, 6))
    _same(got, want)
    assert text.engine.n_front == 0


# ------------------------------------------------------------------ refusals
def test_engine_refusals():
    molmim = build_model(get_smoke_config("molmim-65m"), device="cpu")
    with pytest.raises(ValueError, match="launch.serve.generate"):
        LLM(molmim, slots=2, max_len=32)
    whisper = build_model(get_smoke_config("whisper-medium"), device="cpu")
    audio = np.zeros((1, 16, whisper.cfg.d_model), np.float32)
    vlm = build_model(get_smoke_config("internvl2-26b"), device="cpu")
    img = np.zeros((1, 16, vlm.cfg.d_model), np.float32)
    for m, extra in ((whisper, {"enc_embeds": audio}), (whisper, None),
                     (vlm, {"img_embeds": img})):
        for kw in (dict(prefix_cache=True), dict(prefill_chunk=4)):
            with pytest.raises(ValueError, match="no frontend rows"):
                LLM(m, slots=2, max_len=32, cache_layout="paged", extra_batch=extra, **kw)
        with pytest.raises(ValueError, match="no single token-aligned"):
            LLM(m, slots=2, max_len=32, extra_batch=extra).embed([[1, 2, 3]])
    # the image rows count toward the budget: 16 + 10 + 8 > 32
    llm = LLM(vlm, slots=2, max_len=32, extra_batch={"img_embeds": img})
    with pytest.raises(ValueError, match="overflows max_len"):
        llm.generate([list(range(10))], SamplingParams(max_new=8))
    # with an image, an empty prompt has rows to condition on
    out = llm.generate([[]], SamplingParams(max_new=3))
    assert len(out[0].tokens) == 3
    with pytest.raises(ValueError, match="empty prompt"):
        LLM(vlm, slots=2, max_len=32).generate([[]], SamplingParams(max_new=3))
