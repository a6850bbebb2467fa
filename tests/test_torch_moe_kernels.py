"""The MoE's ragged grouped matmul on the CPU: the plain PyTorch version
against the reference's TPU kernel run in Pallas interpret mode and against
its gather oracle, on the same seeded numpy inputs, across group counts and
ragged edge cases; the op's dispatch; and the kernel wrapper's refusals."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.grouped_matmul import gmm as jax_gmm  # noqa: E402
from repro_torch.kernels import grouped_matmul as gm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

# (E, M, sizes): one group, empty groups, a dropped tail (sum < M), interior
# empty groups, all groups empty, and M = 50, not a multiple of any tile
CASES = [
    (2, 40, [40, 0]),
    (2, 40, [0, 23]),
    (8, 64, [5, 0, 9, 0, 0, 12, 3, 20]),
    (8, 64, [0] * 8),
    (16, 50, [3, 0, 0, 7, 1, 0, 9, 2, 0, 4, 6, 0, 8, 1, 0, 9]),
    (16, 50, [0, 0, 11, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 20, 0]),
]


def _inputs(E, M, sizes, dtype, K=96, N=80, seed=0):
    rng = np.random.default_rng(seed + E + M)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (0.3 * rng.standard_normal((E, K, N))).astype(np.float32)
    gs = np.asarray(sizes, np.int32)
    t = (torch.from_numpy(x).to(TDT[dtype]), torch.from_numpy(w).to(TDT[dtype]),
         torch.from_numpy(gs))
    j = (jnp.asarray(x, JDT[dtype]), jnp.asarray(w, JDT[dtype]), jnp.asarray(gs))
    return t, j


def _close(got, want, dtype):
    if dtype == "float32":
        # the same fp32 products summed in another order
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        # both round one fp32 sum to bf16: within two bf16 steps (2^-6 of |y|)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=2**-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,M,sizes", CASES, ids=lambda c: str(c))
def test_plain_grouped_matmul_matches_pallas_gmm_and_oracle(E, M, sizes, dtype):
    (x, w, gs), (jx, jw, jgs) = _inputs(E, M, sizes, dtype)
    got = ref.grouped_matmul_ref(x, w, gs)
    assert got.dtype == x.dtype and got.shape == (M, w.shape[2])
    got = got.float().numpy()
    total = sum(sizes)
    assert (got[total:] == 0).all()               # the dropped tail, exactly
    for want in (jax_gmm(jx, jw, jgs, block_m=16, interpret=True),
                 jax_ref.grouped_matmul_ref(jx, jw, jgs)):
        want = np.asarray(jnp.asarray(want, jnp.float32))
        _close(got, want, dtype)
        assert (want[total:] == 0).all()


def test_ops_grouped_matmul_dispatch_on_the_cpu():
    """``auto`` on CPU tensors and ``torch`` both run the plain version and
    launch nothing; the plain version is differentiable and its gradients
    are those of a per-group product."""
    (x, w, gs), _ = _inputs(8, 64, CASES[2][2], "float32")
    before = gm.gmm.launches
    want = ref.grouped_matmul_ref(x, w, gs)
    for impl in ("auto", "torch"):
        assert torch.equal(ops.grouped_matmul(x, w, gs, impl=impl), want)
    assert gm.gmm.launches == before
    with pytest.raises(ValueError, match="unknown kernel impl"):
        ops.grouped_matmul(x, w, gs, impl="pallas")
    x.requires_grad_(True)
    w.requires_grad_(True)
    ops.grouped_matmul(x, w, gs).sum().backward()
    ends = np.cumsum(CASES[2][2])
    for g, (lo, hi) in enumerate(zip(ends - np.asarray(CASES[2][2]), ends)):
        want_dw = x.detach()[lo:hi].sum(0)[:, None].expand(-1, w.shape[2])
        torch.testing.assert_close(w.grad[g], want_dw, atol=1e-5, rtol=0)
    assert (x.grad[ends[-1]:] == 0).all()


def test_kernel_wrapper_refuses_a_gradient_and_foreign_devices():
    """Off the CPU the wrapper launches the kernel or raises: a tensor that
    needs a gradient is refused before anything else (the kernel is
    forward-only), and a non-CUDA device after that."""
    x = torch.empty(4, 16, dtype=torch.bfloat16, device="meta", requires_grad=True)
    w = torch.empty(2, 16, 8, dtype=torch.bfloat16, device="meta")
    gs = torch.empty(2, dtype=torch.int32, device="meta")
    with pytest.raises(NotImplementedError, match="forward-only"):
        gm.gmm(x, w, gs)
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA device"):
            gm.gmm(x, w, gs)
    assert gm.gmm.launches == 0


@pytest.mark.parametrize("bad,match", [
    (dict(x=(4, 16), w=(2, 24, 8)), "expected x"),
    (dict(gs_dtype=torch.int64), "int32"),
    (dict(w=(129, 16, 8)), "1 to 128 groups"),
    (dict(dtype=torch.float32), "bfloat16"),
    (dict(w=(2, 16, 12)), "multiples of 8"),
])
def test_kernel_argument_checks(bad, match):
    xs, ws = bad.get("x", (4, 16)), bad.get("w", (2, 16, 8))
    dt = bad.get("dtype", torch.bfloat16)
    x, w = torch.zeros(xs, dtype=dt), torch.zeros(ws, dtype=dt)
    gs = torch.zeros(ws[0], dtype=bad.get("gs_dtype", torch.int32))
    with pytest.raises((ValueError, TypeError), match=match):
        gm.check_args(x, w, gs)


def test_block_m_follows_the_row_count():
    assert [gm.block_m(m) for m in (1, 32, 128, 129, 1024)] == [16, 16, 16, 64, 64]
