"""The port's SSD plain versions against the reference on the CPU: the
chunked scan ``ssd_scan_ref`` (the CUDA kernel's math) against the
reference's Pallas ``ssd_scan`` in interpret mode and against the
sequential oracle ``ssd_ref`` at tail lengths, the recurrent decode step
against ``ops.ssd_decode_step``, a decode chain against the scan, and the
kernel wrapper's CPU route and argument checks."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402

# fp32: sums of the same fp32 products in another order (the reference
# kernel test's tolerance); bf16: the reference test's, x, B and C given in
# bf16 and y rounded to it
TOL = {"float32": dict(atol=2e-4, rtol=1e-3), "bfloat16": dict(atol=2e-1, rtol=1e-1)}


def _inputs(B, S, H, P, G, N, seed=0, dt_shift=0.0):
    """numpy inputs in the SSD's ranges: dt = softplus(·) > 0, A < 0."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(x=rng.standard_normal((B, S, H, P)).astype(f),
                dt=np.log1p(np.exp(rng.standard_normal((B, S, H)) + dt_shift)).astype(f),
                A=(-np.exp(rng.standard_normal(H))).astype(f),
                Bm=rng.standard_normal((B, S, G, N)).astype(f),
                Cm=rng.standard_normal((B, S, G, N)).astype(f),
                D=rng.standard_normal(H).astype(f))


def _torch(a, dtype="float32", name=""):
    t = torch.from_numpy(a)
    return t.to(torch.bfloat16) if dtype == "bfloat16" and name in ("x", "Bm", "Cm") else t


def _jax(a, dtype="float32", name=""):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" and name in ("x", "Bm", "Cm")
                       else jnp.float32)


def _args(inp, conv, dtype="float32"):
    return [conv(inp[k], dtype, k) for k in ("x", "dt", "A", "Bm", "Cm", "D")]


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not torch.is_tensor(x) else x.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 2])
def test_scan_matches_the_pallas_kernel_in_interpret_mode(G, dtype):
    inp = _inputs(2, 48, 4, 8, G, 8, seed=G)
    y, h = ref.ssd_scan_ref(*_args(inp, _torch, dtype), chunk=16)
    want_y, want_h = jax_ssd_scan(*_args(inp, _jax, dtype), chunk=16, interpret=True)
    assert y.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    assert h.dtype == torch.float32 and h.shape == (2, 4, 8, 8)
    np.testing.assert_allclose(_np(y), _np(want_y), **TOL[dtype])
    np.testing.assert_allclose(h.numpy(), _np(want_h), **TOL[dtype])


@pytest.mark.parametrize("S", [1, 7, 45])
def test_scan_at_tail_lengths_matches_the_sequential_oracle(S):
    """S not a multiple of the chunk (and shorter than one): the padded
    tail adds nothing to the state and does not decay it."""
    inp = _inputs(2, S, 4, 8, 2, 8, seed=S)
    want_y, want_h = jax_ref.ssd_ref(*_args(inp, _jax))
    for chunk in (16, 64):
        y, h = ref.ssd_scan_ref(*_args(inp, _torch), chunk=chunk)
        np.testing.assert_allclose(y.numpy(), _np(want_y), **TOL["float32"])
        np.testing.assert_allclose(h.numpy(), _np(want_h), **TOL["float32"])
    y, h = ref.ssd_ref(*_args(inp, _torch))
    np.testing.assert_allclose(y.numpy(), _np(want_y), **TOL["float32"])
    np.testing.assert_allclose(h.numpy(), _np(want_h), **TOL["float32"])


def test_large_steps_give_no_nan_and_a_finite_gradient():
    """dt·|A| of tens a row: exp(cum_t − cum_s) above the diagonal
    overflows, and the scan selects it away instead of multiplying by a
    mask — in the forward and in autograd's backward."""
    inp = _inputs(1, 40, 2, 8, 1, 8, seed=3, dt_shift=3.0)
    inp["A"] = np.full(2, -16.0, np.float32)
    args = [a.requires_grad_() for a in _args(inp, _torch)]
    y, h = ref.ssd_scan_ref(*args, chunk=32)
    want_y, want_h = jax_ref.ssd_ref(*_args(inp, _jax))
    np.testing.assert_allclose(y.detach().numpy(), _np(want_y), **TOL["float32"])
    np.testing.assert_allclose(h.detach().numpy(), _np(want_h), **TOL["float32"])
    (y.sum() + h.sum()).backward()
    assert all(torch.isfinite(a.grad).all() for a in args)


def test_decode_step_matches_the_reference_and_advances_in_place():
    inp = _inputs(3, 1, 4, 8, 2, 8, seed=5)
    state = np.random.default_rng(6).standard_normal((3, 4, 8, 8)).astype(np.float32)
    st = torch.from_numpy(state.copy())
    y, out = ops.ssd_decode_step(*_args(inp, _torch), st)
    want_y, want_state = jax_ops.ssd_decode_step(*_args(inp, _jax), jnp.asarray(state))
    assert out is st and y.shape == (3, 1, 4, 8)
    np.testing.assert_allclose(y.numpy(), _np(want_y), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(st.numpy(), _np(want_state), atol=1e-5, rtol=1e-5)


def test_decode_chain_matches_the_scan():
    """Stepping the recurrence row by row from a zero state gives the
    scan's y at every row and its final state."""
    inp = _inputs(1, 12, 2, 4, 1, 4, seed=7)
    want_y, want_h = ref.ssd_scan_ref(*_args(inp, _torch), chunk=8)
    args = _args(inp, _torch)
    state = torch.zeros(1, 2, 4, 4)
    for t in range(12):
        step = [a[:, t:t + 1] if a.dim() > 1 else a for a in args]
        y, state = ops.ssd_decode_step(*step, state)
        np.testing.assert_allclose(y[:, 0].numpy(), want_y[:, t].numpy(), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(state.numpy(), want_h.numpy(), atol=2e-4, rtol=1e-3)


def test_wrapper_runs_the_plain_version_on_the_cpu_and_checks_its_arguments():
    inp = _inputs(1, 20, 2, 32, 1, 16, seed=8)
    args = _args(inp, _torch, "bfloat16")
    before = ss.ssd_scan.launches
    y, h = ss.ssd_scan(*args, chunk=8)
    want_y, want_h = ref.ssd_scan_ref(*args, chunk=8)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    assert ss.ssd_scan.launches == before
    y2, _ = ops.ssd(*args, chunk=8, impl="torch")
    assert torch.equal(y2, want_y)
    ss.check_args(*args)
    # strided views, as the SSM block slices them out of one activation
    conv = torch.zeros(1, 20, 2 * 32 + 2 * 16, dtype=torch.bfloat16)
    x = conv[..., :64].unflatten(-1, (2, 32))
    Bm, Cm = conv[..., 64:80].unflatten(-1, (1, 16)), conv[..., 80:].unflatten(-1, (1, 16))
    ss.check_args(x, args[1], args[2], Bm, Cm, args[5])
    bad = {
        "P a multiple": (args[0][..., :16], *args[1:]),
        "bfloat16": (args[0].float(), *args[1:]),
        "float32": (args[0], args[1].to(torch.bfloat16), *args[2:]),
        "whole number": (args[0], args[1], args[2], torch.cat([args[3]] * 3, 2),
                         torch.cat([args[4]] * 3, 2), args[5]),
        "up to 128": (args[0], args[1], args[2], torch.cat([args[3]] * 9, 3),
                      torch.cat([args[4]] * 9, 3), args[5]),
        "contiguous": (args[0].transpose(2, 3).contiguous().transpose(2, 3), *args[1:]),
        "dt must be": (args[0], args[1][:, :10], *args[2:]),
    }
    for match, a in bad.items():
        with pytest.raises((ValueError, TypeError), match=match):
            ss.check_args(*a)
    with pytest.raises(ValueError, match="unknown kernel impl"):
        ops.ssd_decode_step(*_args(inp, _torch)[:6], torch.zeros(1, 2, 32, 16), impl="triton")
