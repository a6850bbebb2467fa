"""The MoE's ragged grouped matmul on the CPU: the plain PyTorch version
against the reference's TPU kernel run in Pallas interpret mode and against
its gather oracle, on the same seeded numpy inputs, across group counts and
ragged edge cases; its gradients against ``jax.vjp`` of the reference's
custom VJP; the op's dispatch; and the kernel wrappers' refusals."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
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
    """Off the CPU the wrappers launch the kernel or raise: a tensor that
    needs a gradient is no longer refused (the backward is ``gmm_dw`` and
    the transposed ``gmm``), and a non-CUDA device is, in every entry —
    the forward, the transposed mode, the weight gradient and the
    differentiable op."""
    x = torch.empty(4, 16, dtype=torch.bfloat16, device="meta", requires_grad=True)
    w = torch.empty(2, 16, 8, dtype=torch.bfloat16, device="meta", requires_grad=True)
    dy = torch.empty(4, 8, dtype=torch.bfloat16, device="meta")
    gs = torch.empty(2, dtype=torch.int32, device="meta")
    for call in (lambda: gm.gmm(x, w, gs), lambda: gm.gmm(dy, w, gs, transpose_w=True),
                 lambda: gm.gmm_dw(x, dy, gs), lambda: gm.grouped_matmul(x, w, gs),
                 lambda: ops.grouped_matmul(x, w, gs)):
        with pytest.raises(ValueError, match="CUDA device"):
            call()
    assert gm.gmm.launches == gm.gmm_dw.launches == 0


@pytest.mark.parametrize("route", ["ops", "function"])
def test_grouped_matmul_vjp_matches_reference(route):
    """x and w gradients of the port's grouped matmul against ``jax.vjp`` of
    the reference's Pallas op (its custom VJP: ``gmm`` on the swapped
    weights and ``gmm_dw``, interpret mode), in fp32 on the CPU: ``ops``
    is the plain version under autograd (the CPU route), ``function`` the
    autograd Function that pairs the kernels, here on their plain
    versions."""
    fn = ops.grouped_matmul if route == "ops" else gm.grouped_matmul

    @jax.jit
    def jvjp(x, w, gs, cot):
        y, pull = jax.vjp(lambda a, b: jax_ops.grouped_matmul(
            a, b, gs, impl="pallas", interpret=True), x, w)
        return (y, *pull(cot))

    for E, M, sizes in CASES:      # three shapes: one compile of the reference's VJP each
        (x, w, gs), (jx, jw, jgs) = _inputs(E, M, sizes, "float32")
        cot = np.random.default_rng(M).standard_normal((M, w.shape[2])).astype(np.float32)
        jy, jdx, jdw = jvjp(jx, jw, jgs, jnp.asarray(cot))
        x.requires_grad_(True)
        w.requires_grad_(True)
        y = fn(x, w, gs)
        dx, dw = torch.autograd.grad(y, (x, w), torch.from_numpy(cot))
        # the same fp32 products summed in another order
        for got, want in ((y, jy), (dx, jdx), (dw, jdw)):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4, rtol=0,
                                       err_msg=str(sizes))
        total = sum(sizes)
        assert (dx[total:] == 0).all()                # the dropped tail gets no gradient
        for g in np.flatnonzero(np.asarray(sizes) == 0):
            assert (dw[g] == 0).all()


def test_wrappers_plain_versions_on_the_cpu():
    """On CPU tensors the transposed mode is the product with each
    weight's transpose and ``gmm_dw`` the plain weight gradient rounded to
    its output dtype; neither launches."""
    (x, w, gs), _ = _inputs(8, 64, CASES[2][2], "bfloat16")
    dy = torch.randn(64, w.shape[2], generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    assert torch.equal(gm.gmm(dy, w, gs, transpose_w=True),
                       ref.grouped_matmul_ref(dy, w.transpose(1, 2), gs))
    want = ref.grouped_matmul_dw_ref(x, dy, gs)
    assert torch.equal(gm.gmm_dw(x, dy, gs), want)
    assert torch.equal(gm.gmm_dw(x, dy, gs, out_dtype=torch.bfloat16), want.to(torch.bfloat16))
    assert gm.gmm.launches == gm.gmm_dw.launches == 0


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


@pytest.mark.parametrize("bad,match", [
    (dict(x=(4, 16), w=(2, 16, 8)), "expected x"),
    (dict(x=(4, 16), w=(2, 8, 24)), "expected x"),
    (dict(w=(2, 8, 16), gs_dtype=torch.int64), "int32"),
    (dict(w=(129, 8, 16)), "1 to 128 groups"),
    (dict(w=(2, 8, 16), dtype=torch.float32), "bfloat16"),
    (dict(x=(4, 12), w=(2, 8, 12)), "multiples of 8"),
])
def test_transposed_kernel_argument_checks(bad, match):
    """The transposed mode reads w as (E, N, K): x's width must be w's
    last dim."""
    xs, ws = bad.get("x", (4, 16)), bad["w"]
    dt = bad.get("dtype", torch.bfloat16)
    x, w = torch.zeros(xs, dtype=dt), torch.zeros(ws, dtype=dt)
    gs = torch.zeros(ws[0], dtype=bad.get("gs_dtype", torch.int32))
    with pytest.raises((ValueError, TypeError), match=match):
        gm.check_args(x, w, gs, transpose_w=True)


@pytest.mark.parametrize("bad,match", [
    (dict(dy=(5, 8)), "expected x"),
    (dict(gs=(2, 1)), "int32"),
    (dict(gs_dtype=torch.int64), "int32"),
    (dict(gs=(129,)), "1 to 128 groups"),
    (dict(dtype=torch.float32), "bfloat16"),
    (dict(x=(4, 12)), "multiples of 8"),
])
def test_dw_kernel_argument_checks(bad, match):
    dt = bad.get("dtype", torch.bfloat16)
    x, dy = torch.zeros(bad.get("x", (4, 16)), dtype=dt), torch.zeros(bad.get("dy", (4, 8)), dtype=dt)
    gs = torch.zeros(bad.get("gs", (2,)), dtype=bad.get("gs_dtype", torch.int32))
    with pytest.raises((ValueError, TypeError), match=match):
        gm.check_dw_args(x, dy, gs)


def test_block_m_follows_the_row_count():
    assert [gm.block_m(m) for m in (1, 32, 128, 129, 1024)] == [16, 16, 16, 64, 64]
