"""The port's kernel ops on the CPU (their plain PyTorch versions) against
the reference's TPU kernels run in Pallas interpret mode, on the same
seeded numpy inputs; plus the kernel wrappers' argument checks and the
CPU dispatch."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import flash_attention_fwd as jax_flash_attention_fwd  # noqa: E402
from repro.kernels.rmsnorm import layernorm as jax_layernorm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import check_args, flash_attention_fwd  # noqa: E402
from repro_torch.kernels.rmsnorm import layernorm  # noqa: E402

# (B, S, T, H, Hkv, D, kwargs)
ATTN_CASES = {
    "bidirectional": (2, 32, 32, 4, 4, 64, dict(causal=False)),
    "causal": (2, 32, 32, 4, 4, 64, dict(causal=True)),
    "window": (2, 40, 40, 2, 2, 64, dict(causal=True, window=9)),
    "softcap": (2, 24, 24, 2, 2, 64, dict(causal=False, softcap=5.0)),
    "gqa": (2, 32, 32, 8, 2, 64, dict(causal=True)),
    "q_offset": (1, 16, 48, 4, 2, 128, dict(causal=True, q_offset=32)),
    "non_multiple": (2, 40, 72, 2, 2, 64, dict(causal=False)),
    "fully_masked_rows": (1, 16, 16, 2, 2, 64, dict(causal=True, q_offset=-5)),
}

# fp32: the same fp32 math in another summation order.  bf16: both compute
# in fp32 from identical bf16 inputs and round the output to bf16 once, so
# they differ by at most one bf16 step (2^-8 relative; 2^-7 of |out| at
# worst); lse stays fp32 in both.
TOL = {
    "float32": dict(out=dict(atol=1e-5, rtol=0.0), lse=1e-5),
    "bfloat16": dict(out=dict(atol=1e-2, rtol=2**-7), lse=1e-4),
}


def _inputs(shapes, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    return ([torch.from_numpy(a).to(tdt) for a in arrs],
            [jnp.asarray(a, jdt) for a in arrs])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_matches_pallas_flash_attention_fwd(case, dtype):
    B, S, T, H, Hkv, D, kw = ATTN_CASES[case]
    (q, k, v), (jq, jk, jv) = _inputs([(B, S, H, D), (B, T, Hkv, D), (B, T, Hkv, D)], dtype, 0)
    # 16-row blocks so the reference pads and masks the ragged tails
    want_out, want_lse = jax_flash_attention_fwd(
        jq, jk, jv, block_q=16, block_k=16, interpret=True, **kw)
    out, lse = flash_attention_fwd(q, k, v, **kw)
    assert out.dtype == q.dtype and out.shape == (B, S, H, D)
    assert lse.dtype == torch.float32 and lse.shape == (B * H, S)
    tol = TOL[dtype]
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want_out.astype(jnp.float32)),
                               **tol["out"])
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=tol["lse"], rtol=0)
    if case == "fully_masked_rows":
        assert (out[:, :5] == 0).all() and (lse.reshape(B, H, S)[:, :, :5] == -1e30).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [True, False])
def test_layernorm_matches_pallas_layernorm(bias, dtype):
    (x, w, b), (jx, jw, jb) = _inputs([(6, 10, 80), (80,), (80,)], dtype, 1)
    x = x * 3 + 1
    jx = jx * 3 + 1
    w, b, jw, jb = w.float(), b.float(), jw.astype(jnp.float32), jb.astype(jnp.float32)
    want = jax_layernorm(jx, jw, jb if bias else None, interpret=True)
    got = layernorm(x, w, b if bias else None)
    assert got.dtype == x.dtype and got.shape == x.shape
    tol = TOL[dtype]["out"]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **tol)


def test_cpu_tensors_run_the_plain_versions_and_launch_nothing():
    (q, k, v), _ = _inputs([(1, 8, 2, 64)] * 3, "float32", 2)
    before = (flash_attention_fwd.launches, layernorm.launches)
    out, lse = flash_attention_fwd(q, k, v, causal=True)
    r_out, r_lse = ref.attention_ref(q, k, v, causal=True)
    assert torch.equal(out, r_out) and torch.equal(lse, r_lse)
    w = torch.ones(64)
    assert torch.equal(layernorm(q, w), ref.layernorm_ref(q, w))
    assert torch.equal(ops.attention(q, k, v, impl="torch"), r_out)
    assert (flash_attention_fwd.launches, layernorm.launches) == before


def test_ops_reject_unknown_impl():
    (q,), _ = _inputs([(1, 8, 2, 64)], "float32", 3)
    with pytest.raises(ValueError, match="unknown kernel impl"):
        ops.attention(q, q, q, impl="pallas")
    with pytest.raises(ValueError, match="unknown kernel impl"):
        ops.layernorm(q, torch.ones(64), impl="xla")


def test_flash_attention_kernel_argument_checks():
    def t(*shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype)

    check_args(t(2, 8, 4, 64), t(2, 8, 2, 64), t(2, 8, 2, 64))   # GQA bf16 takes
    check_args(t(2, 8, 4, 128, dtype=torch.float16), *[t(2, 8, 4, 128, dtype=torch.float16)] * 2)
    with pytest.raises(ValueError, match="head_dim 64 or 128"):
        check_args(t(2, 8, 4, 96), t(2, 8, 4, 96), t(2, 8, 4, 96))
    with pytest.raises(TypeError, match="bfloat16 or float16"):
        check_args(*[t(2, 8, 4, 64, dtype=torch.float32)] * 3)
    with pytest.raises(ValueError, match="do not match"):
        check_args(t(2, 8, 4, 64), t(2, 8, 3, 64), t(2, 8, 3, 64))
    with pytest.raises(ValueError, match="contiguous"):
        check_args(t(2, 8, 4, 128)[..., ::2], t(2, 8, 4, 64), t(2, 8, 4, 64))
