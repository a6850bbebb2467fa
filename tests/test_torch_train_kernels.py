"""The port's backward ops on the CPU (their plain PyTorch versions) against
the reference's TPU kernels in Pallas interpret mode, on the same seeded
numpy inputs: the flash-attention backward, the fused cross-entropy forward
and backward, and the LayerNorm backward; plus the differentiable ops'
autograd wiring, the new wrappers' argument checks and the CPU dispatch."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels.cross_entropy import fused_cross_entropy, fused_cross_entropy_bwd  # noqa: E402
from repro.kernels.flash_attention import flash_attention_bwd as jax_flash_attention_bwd  # noqa: E402
from repro_torch.kernels import cross_entropy as ce  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.rmsnorm import layernorm  # noqa: E402
from test_torch_kernels import ATTN_CASES  # noqa: E402

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

# fp32: the same fp32 formulas summed in another order.  bf16: both upcast
# the same bf16 inputs, keep p and ds in fp32 and round each gradient to
# bf16 once, so they differ by at most one bf16 step (2^-8 relative, 2^-7
# of |g| at worst) plus the fp32 summation noise near zero.
GRAD_TOL = {"float32": dict(atol=2e-5, rtol=1e-5), "bfloat16": dict(atol=1e-2, rtol=2**-7)}


def _arrays(shapes, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal(s)).astype(np.float32) for s in shapes]


def _pair(a, dtype):
    return torch.from_numpy(a).to(TDT[dtype]), jnp.asarray(a, JDT[dtype])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


# ------------------------------------------------------------ attention
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_bwd_matches_pallas_flash_attention_bwd(case, dtype):
    B, S, T, H, Hkv, D, kw = ATTN_CASES[case]
    arrs = _arrays([(B, S, H, D), (B, T, Hkv, D), (B, T, Hkv, D), (B, S, H, D)], 10)
    (q, jq), (k, jk), (v, jv), (do, jdo) = (_pair(a, dtype) for a in arrs)
    # one forward (the port's plain one) feeds both backward passes, so the
    # comparison isolates the backward; 16-row blocks pad the ragged tails
    out, lse = ref.attention_ref(q, k, v, **kw)
    jout, jlse = jnp.asarray(out.float().numpy(), JDT[dtype]), jnp.asarray(lse.numpy())
    want = jax_flash_attention_bwd(jq, jk, jv, jout, jlse, jdo, block_q=16, block_k=16,
                                   interpret=True, **kw)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape
        _close(g, w.astype(jnp.float32), GRAD_TOL[dtype])
    if case == "fully_masked_rows":
        assert (got[0][:, :5] == 0).all()       # rows that see no key: zero dq


def test_attention_autograd_runs_the_plain_backward():
    q, k, v, do = (torch.from_numpy(a) for a in
                   _arrays([(2, 24, 4, 64), (2, 24, 2, 64), (2, 24, 2, 64), (2, 24, 4, 64)], 11))
    for impl in ("auto", "torch"):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = ops.attention(*leaves, causal=True, window=7, impl=impl)
        got = torch.autograd.grad(out, leaves, do)
        r_out, r_lse = ref.attention_ref(q, k, v, causal=True, window=7)
        want = ref.attention_bwd_ref(q, k, v, r_out, r_lse, do, causal=True, window=7)
        assert torch.equal(out.detach(), r_out)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


# ------------------------------------------------------------ cross-entropy
CE_CASES = {
    # (T, D, Vpad, vocab, block_v): vocab < Vpad, a ragged token tail, and
    # several vocab blocks with one fully padded
    "padded_vocab": (100, 64, 256, 33, 128),
    "multi_block": (70, 32, 384, 300, 128),
}


def _ce_inputs(case, dtype, seed):
    T, D, Vp, vocab, bv = CE_CASES[case]
    h, w, gl, gs = _arrays([(T, D), (D, Vp), (T,), (T,)], seed)
    w *= 0.3
    rng = np.random.default_rng(seed + 1)
    tgt = rng.integers(0, vocab, size=T).astype(np.int32)
    gl, gs = np.abs(gl) / T, 0.1 * gs / T            # nonzero g_lse
    th, jh = _pair(h, dtype)
    tw, jw = _pair(w, dtype)
    return (th, tw, torch.from_numpy(tgt), torch.from_numpy(gl), torch.from_numpy(gs)), \
        (jh, jw, jnp.asarray(tgt), jnp.asarray(gl), jnp.asarray(gs)), vocab, bv


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CE_CASES))
def test_cross_entropy_matches_pallas_fused_cross_entropy(case, dtype):
    (h, w, tgt, gl, gs), (jh, jw, jtgt, jgl, jgs), vocab, bv = _ce_inputs(case, dtype, 20)
    want_loss, want_lse = fused_cross_entropy(jh, jw, jtgt, vocab=vocab, block_t=32, block_v=bv,
                                              interpret=True)
    loss, lse = ce.cross_entropy_fwd(h, w, tgt, vocab=vocab)
    assert loss.dtype == lse.dtype == torch.float32 and loss.shape == (h.shape[0],)
    # fp32 logits of the same upcast values, summed in another order
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=2e-5, rtol=1e-5)

    want_dh, want_dw = fused_cross_entropy_bwd(jh, jw, jtgt, want_lse, jgl, jgs, vocab=vocab,
                                               block_t=32, block_v=bv, interpret=True)
    dh, dw = ce.cross_entropy_bwd(h, w, tgt, torch.from_numpy(np.asarray(want_lse)), gl, gs,
                                  vocab=vocab)
    assert dh.dtype == h.dtype and dw.dtype == w.dtype and dw.shape == w.shape
    _close(dh, want_dh.astype(jnp.float32), GRAD_TOL[dtype])
    _close(dw, want_dw.astype(jnp.float32), GRAD_TOL[dtype])
    assert (dw[:, vocab:] == 0).all()              # padded columns: exactly zero


def test_cross_entropy_autograd_takes_both_cotangents():
    (h, w, tgt, gl, gs), _, vocab, _ = _ce_inputs("padded_vocab", "float32", 21)
    for impl in ("auto", "torch"):
        hh, ww = h.clone().requires_grad_(True), w.clone().requires_grad_(True)
        loss, lse = ops.cross_entropy(hh, ww, tgt, vocab=vocab, impl=impl)
        got = torch.autograd.grad((loss * gl).sum() + (lse * gs).sum(), [hh, ww])
        r_loss, r_lse = ref.cross_entropy_ref(h, w, tgt, vocab)
        want = ref.cross_entropy_bwd_ref(h, w, tgt, r_lse, gl, gs, vocab)
        assert torch.equal(loss.detach(), r_loss)
        for g, x in zip(got, want):
            assert torch.equal(g, x)


def test_cross_entropy_matches_the_reference_naive_path():
    (h, w, tgt, _, _), (jh, jw, jtgt, _, _), vocab, _ = _ce_inputs("multi_block", "float32", 22)
    want_loss, _ = jax_ops.cross_entropy(jh, jw, jtgt, vocab=vocab, impl="naive")
    loss, _ = ops.cross_entropy(h, w, tgt, vocab=vocab)
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss), atol=2e-5, rtol=1e-5)


def test_out_of_range_target_gives_the_kernels_sentinel():
    h, w = (torch.from_numpy(a) for a in _arrays([(3, 16), (16, 8)], 23))
    loss, lse = ref.cross_entropy_ref(h, w, torch.tensor([0, 6, 7]), vocab=6)
    assert torch.isfinite(loss[0]) and (loss[1:] > 1e29).all()   # lse - (-1e30)


def test_dw_splits_fill_the_card_and_stay_within_the_token_tiles():
    assert ce.dw_splits(8192, 1280, 256) == 7        # 40 blocks per share -> 280
    assert ce.dw_splits(64, 1280, 256) == 1          # one token tile
    assert ce.dw_splits(8192, 1280, 32768) == 1      # 5120 blocks already


def test_cross_entropy_kernel_argument_checks():
    def t(*shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype)

    tgt = torch.zeros(8, dtype=torch.int32)
    ce.check_args(t(8, 64), t(64, 256), tgt)
    ce.check_args(t(8, 64), t(256, 64).T, tgt)            # the tied head's transposed view
    with pytest.raises(ValueError, match="expected hidden"):
        ce.check_args(t(8, 64), t(32, 256), tgt)
    for dt in (torch.float32, torch.float16):
        with pytest.raises(TypeError, match="take bfloat16"):
            ce.check_args(t(8, 64, dtype=dt), t(64, 256, dtype=dt), tgt)
    with pytest.raises(ValueError, match="multiple of 8"):
        ce.check_args(t(8, 60), t(60, 256), tgt)
    with pytest.raises(ValueError, match="rows must be contiguous"):
        ce.check_args(t(64, 8).T, t(64, 256), tgt)
    with pytest.raises(TypeError, match="integer"):
        ce.check_args(t(8, 64), t(64, 256), tgt.float())


def test_flash_attention_bwd_argument_checks():
    def t(*shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype)

    q, k = t(2, 8, 4, 64), t(2, 8, 2, 64)
    fa.check_args(q, k, k, q, q)
    with pytest.raises(ValueError, match="q's shape"):
        fa.check_args(q, k, k, q, t(2, 8, 4, 128))
    with pytest.raises(TypeError, match="one dtype"):
        fa.check_args(q, k, k, q, t(2, 8, 4, 64, dtype=torch.float16))
    with pytest.raises(ValueError, match="dO: head dim must be contiguous"):
        fa.check_args(q, k, k, q, t(2, 8, 4, 128)[..., ::2])


# ------------------------------------------------------------ layernorm
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [True, False])
def test_layernorm_bwd_matches_jax_vjp(bias, dtype, monkeypatch):
    if dtype == "bfloat16":
        monkeypatch.setenv("REPRO_FORCE_IMPL", "pallas_interpret")
    x, w, b, dy = _arrays([(6, 10, 80), (80,), (80,), (6, 10, 80)], 30)
    x = 3 * x + 1
    w = 1 + 0.1 * w
    (tx, jx), (tw, jw), (tb, jb), (tdy, jdy) = (_pair(a, dtype) for a in (x, w, b, dy))
    args = (jx, jw, jb) if bias else (jx, jw)
    _, vjp = jax.vjp(lambda *a: jax_ops.layernorm(*a), *args)
    want = vjp(jdy)
    dx, dw, db = ref.layernorm_bwd_ref(tx, tw, tb if bias else None, tdy)
    assert dx.dtype == tx.dtype and dw.dtype == tw.dtype and (db is None) == (not bias)
    # dw/db sum 60 rows: fp32 summation order differs; bf16 as GRAD_TOL
    tol = GRAD_TOL[dtype] if dtype == "bfloat16" else dict(atol=1e-4, rtol=1e-5)
    for g, w_ in zip((dx, dw, db), want):
        _close(g, w_.astype(jnp.float32), tol)


def test_layernorm_autograd_and_dispatch():
    x, w, b, dy = (torch.from_numpy(a) for a in _arrays([(4, 8, 64), (64,), (64,), (4, 8, 64)], 31))
    before = layernorm.launches
    for impl in ("auto", "torch"):
        leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
        y = ops.layernorm(*leaves, impl=impl)
        assert torch.equal(y.detach(), ref.layernorm_ref(x, w, b))
        got = torch.autograd.grad(y, leaves, dy)
        for g, want in zip(got, ref.layernorm_bwd_ref(x, w, b, dy)):
            assert torch.equal(g, want)
    assert layernorm.launches == before
    with pytest.raises(ValueError, match="unknown kernel impl"):
        ops.cross_entropy(x[0], w[:, None].expand(64, 4), torch.zeros(8, dtype=torch.int32),
                          impl="xla")


def test_cpu_backward_launches_no_kernel():
    before = (fa.flash_attention_bwd.launches, ce.cross_entropy_fwd.launches,
              ce.cross_entropy_bwd.launches)
    test_attention_autograd_runs_the_plain_backward()
    test_cross_entropy_autograd_takes_both_cotangents()
    assert (fa.flash_attention_bwd.launches, ce.cross_entropy_fwd.launches,
            ce.cross_entropy_bwd.launches) == before
