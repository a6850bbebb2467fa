"""The port's SSD plain versions against the reference on the CPU: the
chunked scan ``ssd_scan_ref`` (the CUDA kernel's math) against the
reference's Pallas ``ssd_scan`` in interpret mode and against the
sequential oracle ``ssd_ref`` at tail lengths, the recurrent decode step
against ``ops.ssd_decode_step``, a decode chain against the scan, the
CUDA kernel's arithmetic (bf16 tensor-core products with the fp32
operands split into high and low halves) emulated in torch against the
reference's Pallas kernel, the kernel wrapper's CPU route and argument
checks, the explicit chunked backward ``ssd_scan_bwd_ref`` (the backward
kernel's decomposition) against ``jax.grad`` of the reference's scan, and
``SSDScan``'s wiring on its plain halves against autograd of the plain
scan."""
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


def _split(v):
    """v's bf16 high part and the bf16 of what is left, both as fp32."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def _kernel_scan(x, dt, A, Bm, Cm, D, *, L=64, split_update=True):
    """csrc/ssd_scan.cu's arithmetic in torch: chunks of L rows; C·Bᵀ of
    the bf16 inputs summed in fp32; att, the carried state (in C·hᵀ) and x∘w
    (in the state update) each split into bf16 high and low halves, one
    product for each half, summed in fp32.  ``split_update=False`` drops
    the update operand's low half (bf16 update weights)."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf = Bm.float().repeat_interleave(rep, dim=2)
    Cf = Cm.float().repeat_interleave(rep, dim=2)
    pad = -S % L

    def padded(t):
        return torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))

    xp, dtp, Bp, Cp = padded(xf), padded(dtf), padded(Bf), padded(Cf)
    causal = torch.ones(L, L, dtype=torch.bool).tril()[None, :, :, None]
    h = torch.zeros(Bsz, H, P, N)
    ys = []
    for c0 in range(0, S + pad, L):
        xc, dtc, bc, cc = (t[:, c0:c0 + L] for t in (xp, dtp, Bp, Cp))
        cum = torch.cumsum(dtc * Af, dim=1)                        # (B, L, H)
        seg = cum[:, -1]
        diff = cum[:, :, None, :] - cum[:, None, :, :]
        cb = torch.einsum("blhn,bshn->blsh", cc, bc)
        att = torch.where(causal, cb * torch.exp(diff.masked_fill(~causal, 0.0))
                          * dtc[:, None], 0.0)
        h_hi, h_lo = _split(h)
        y = (torch.einsum("blhn,bhpn->blhp", cc, h_hi)
             + torch.einsum("blhn,bhpn->blhp", cc, h_lo)) * torch.exp(cum)[..., None]
        a_hi, a_lo = _split(att)
        y = y + torch.einsum("blsh,bshp->blhp", a_hi, xc) + torch.einsum("blsh,bshp->blhp",
                                                                         a_lo, xc)
        xw_hi, xw_lo = _split(xc * (dtc * torch.exp(seg[:, None] - cum))[..., None])
        upd = torch.einsum("blhp,blhn->bhpn", xw_hi, bc)
        if split_update:
            upd = upd + torch.einsum("blhp,blhn->bhpn", xw_lo, bc)
        h = h * torch.exp(seg)[..., None, None] + upd
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :S] + xf * D.float()[None, None, :, None]
    return y.to(x.dtype), h


def _bf16_steps(got, want):
    """max |got − want| in bf16 steps of each row's max |want| (rows: all
    but the last axis), chip_smoke.check_ssd_scan's measure."""
    top = want.float().abs().amax(-1, keepdim=True).clamp_min(1e-30)
    step = torch.exp2(torch.floor(torch.log2(top)) - 7)
    return ((got.float() - want.float()).abs() / step).max().item()


def _state_err(got, want):
    """max |got − want| over each head's max |want|."""
    g, w = got.flatten(2), want.flatten(2)
    return ((g - w).abs().amax(-1) / w.abs().amax(-1).clamp_min(1e-30)).max().item()


@pytest.mark.parametrize("case", ["mamba2_head", "large_steps"])
def test_kernel_arithmetic_matches_the_pallas_kernel_at_the_chip_gates(case):
    """The split products hold y to 2 bf16 steps and the state to 1e-4 of
    the reference's kernel (the chip check's gates) on Mamba2-2.7B's head
    shape (P 64, N 128) and with large steps (dt·|A| up to ~50 a row);
    without the update operand's low half the state misses its gate."""
    large = case == "large_steps"
    inp = _inputs(1, 256, 3, 64, 1, 128, seed=11, dt_shift=1.5 if large else -2.0)
    if large:
        inp["A"] = -(1 + 15 * np.random.default_rng(12).random(3)).astype(np.float32)
    args = _args(inp, _torch, "bfloat16")
    want_y, want_h = jax_ssd_scan(*_args(inp, _jax, "bfloat16"), chunk=128, interpret=True)
    want_y, want_h = (torch.from_numpy(np.array(_np(t))) for t in (want_y, want_h))
    y, h = _kernel_scan(*args)
    assert torch.isfinite(y.float()).all() and torch.isfinite(h).all()
    assert _bf16_steps(y, want_y) <= 2
    assert _state_err(h, want_h) <= 1e-4
    _, h_bf16 = _kernel_scan(*args, split_update=False)
    assert _state_err(h_bf16, want_h) > 1e-4


# ------------------------------------------------------------ the backward
# (B, S, H, P, G, N, chunk, dt shift, with the final state's gradient)
BWD_CASES = {
    "G1_S_multiple_of_chunk": (2, 48, 4, 8, 1, 8, 16, 0.0, True),
    "G2_S45_tail": (2, 45, 4, 8, 2, 8, 16, 0.0, False),
    "G2_S7_below_chunk": (1, 7, 4, 8, 2, 8, 16, 0.0, True),
    "S1": (1, 1, 2, 8, 1, 4, 16, 0.0, True),
    "large_steps": (1, 40, 2, 8, 1, 8, 16, 3.0, True),
}


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_scan_bwd_ref_matches_jax_grad_of_the_reference_scan(case):
    """Every gradient of ``ssd_scan_bwd_ref`` (given ``ssd_scan_ref``'s chunk
    states) against ``jax.grad`` of the reference's chunked scan
    ``_ssd_chunked_xla`` with cotangents on y and on the final state.  The
    large-step case (dt·|A| of tens a row) goes against the sequential
    oracle ``ssd_ref`` instead: the reference's scan takes exp before its
    causal select, so its own gradient of dt and A is NaN there, where the
    port's selects first and stays finite.  fp32 both: the same products
    summed in another order, held to 1e-5 of each gradient's largest
    magnitude, or of 1 where that is smaller (measured: at most 4e-6 of
    it; the large-step dA, ~2e-6 in all, within 6e-6)."""
    B, S, H, P, G, N, chunk, shift, with_ds = BWD_CASES[case]
    inp = _inputs(B, S, H, P, G, N, seed=S + G, dt_shift=shift)
    if shift:
        inp["A"] = np.full(H, -16.0, np.float32)
    rng = np.random.default_rng(S)
    dy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    ds = rng.standard_normal((B, H, P, N)).astype(np.float32) if with_ds else None

    def loss(*a):
        y, h = (jax_ref.ssd_ref(*a) if shift else jax_ops._ssd_chunked_xla(*a, chunk=chunk))
        return jnp.sum(y * dy) + (jnp.sum(h * ds) if with_ds else 0.0)

    want = jax.grad(loss, argnums=tuple(range(6)))(*_args(inp, _jax))
    args = _args(inp, _torch)
    _, _, states = ref.ssd_scan_ref(*args, chunk=chunk, states=True)
    assert states.shape == (B, -(-S // min(chunk, S)), H, P, N) and not states[:, 0].any()
    got = ref.ssd_scan_bwd_ref(*args, states, torch.from_numpy(dy),
                               None if ds is None else torch.from_numpy(ds), chunk=chunk)
    for name, g, w in zip(("x", "dt", "A", "Bm", "Cm", "D"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert np.isfinite(g.numpy()).all(), name
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * max(np.abs(w).max(), 1.0), rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("outputs", ["y_and_state", "y_only", "state_only"])
def test_ssd_scan_function_on_its_plain_halves_matches_autograd(outputs):
    """``ssd_scan`` with an input that needs a gradient goes through
    ``SSDScan``: on CPU tensors its forward is ``ssd_scan_ref(...,
    states=True)`` and its backward ``ssd_scan_bwd_ref``.  Through x, B and
    C sliced out of one activation (strided views, as the SSM block makes
    them), with the gradient of y, of the final state or of both (the other
    ``None``), every gradient matches autograd of the plain scan: fp32, the
    same products in another order (measured within 1.2e-6 of each
    gradient's largest)."""
    B, S, H, P, G, N = 2, 45, 4, 32, 2, 16
    rng = np.random.default_rng(21)
    conv0 = torch.from_numpy(rng.standard_normal((B, S, H * P + 2 * G * N)).astype(np.float32))
    dt0 = torch.from_numpy(np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32))
    A0 = torch.from_numpy(-(0.5 + rng.random(H)).astype(np.float32))
    D0 = torch.from_numpy(rng.standard_normal(H).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((B, S, H, P)).astype(np.float32))
    ds = torch.from_numpy(rng.standard_normal((B, H, P, N)).astype(np.float32))

    def grads(scan):
        leaves = [t.clone().requires_grad_() for t in (conv0, dt0, A0, D0)]
        conv, dt, A, D = leaves
        x = conv[..., :H * P].unflatten(-1, (H, P))
        Bm = conv[..., H * P:H * P + G * N].unflatten(-1, (G, N))
        Cm = conv[..., H * P + G * N:].unflatten(-1, (G, N))
        y, h = scan(x, dt, A, Bm, Cm, D, chunk=16)
        loss = ((y * dy).sum() if outputs != "state_only" else 0.0) \
            + ((h * ds).sum() if outputs != "y_only" else 0.0)
        return torch.autograd.grad(loss, leaves, allow_unused=True), (y, h)

    before = ss.ssd_scan.launches, ss.ssd_scan_bwd.launches
    got, (y, h) = grads(ss.ssd_scan)
    want, (wy, wh) = grads(ref.ssd_scan_ref)
    assert torch.equal(y, wy) and torch.equal(h, wh)
    assert y.grad_fn is not None and type(y.grad_fn).__name__ == "SSDScanBackward"
    for name, g, w in zip(("conv", "dt", "A", "D"), got, want):
        w = torch.zeros_like(g) if w is None else w    # D does not reach the final state
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5 * max(w.abs().max(), 1.0),
                                   rtol=0, err_msg=name)
    assert (ss.ssd_scan.launches, ss.ssd_scan_bwd.launches) == before


def test_scan_bwd_keeps_the_input_dtypes_and_checks_its_arguments():
    """bf16 x, B and C: dx, dB and dC come back in bf16, ddt in fp32, dA
    and dD in the dtype A and D came in; the backward's argument checks
    (the kernel's) refuse a wrong dy, chunk states or final-state
    gradient."""
    inp = _inputs(1, 70, 2, 32, 1, 16, seed=9)
    args = _args(inp, _torch, "bfloat16")
    args[2], args[5] = args[2].to(torch.bfloat16), args[5].to(torch.bfloat16)
    _, _, states = ref.ssd_scan_ref(*args, chunk=64, states=True)
    dy = torch.ones(1, 70, 2, 32, dtype=torch.bfloat16)
    got = ss.ssd_scan_bwd(*args, states, dy, None)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32, torch.bfloat16,
                                      torch.bfloat16, torch.bfloat16, torch.bfloat16]
    ss.check_bwd_args(args[0], states, dy, torch.zeros(1, 2, 32, 16), 16)
    bad = {
        "states must be": (states[:, :1].contiguous(), dy, None),
        "dy must be": (states, dy.float(), None),
        "dstate must be": (states, dy, torch.zeros(1, 2, 32, 8)),
        "contiguous": (states, dy.transpose(2, 3).contiguous().transpose(2, 3), None),
    }
    for match, (st, d, dstate) in bad.items():
        with pytest.raises(ValueError, match=match):
            ss.check_bwd_args(args[0], st, d, dstate, 16)
