"""The generation path's kernel ops on the CPU — RMSNorm, decode attention
and sampling, their plain PyTorch versions — against the reference's TPU
kernels run in Pallas interpret mode and against its XLA paths, on the
same seeded numpy inputs; plus the kernel wrappers' argument checks."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import sampling as jax_sampling  # noqa: E402
from repro.kernels.flash_decode import flash_decode as jax_flash_decode  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import sampling as sp  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm  # noqa: E402

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _pair(a, dtype):
    return torch.from_numpy(a).to(TDT[dtype]), jnp.asarray(a, JDT[dtype])


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------------ rmsnorm
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 5, 256), (7, 200)])
def test_rmsnorm_matches_pallas_rmsnorm(shape, dtype):
    rng = np.random.default_rng(0)
    x, jx = _pair((2.0 * rng.standard_normal(shape) + 0.5).astype(np.float32), dtype)
    w, jw = _pair(rng.standard_normal(shape[-1]).astype(np.float32), "float32")
    want = _np(jax_rmsnorm(jx, jw, interpret=True))
    for got in (rmsnorm(x, w), ops.rmsnorm(x, w), ops.rmsnorm(x, w, impl="torch")):
        assert got.dtype == x.dtype and got.shape == x.shape
        if dtype == "float32":
            # the same fp32 math, summed in another order
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
        else:
            # both round the fp32 result to bf16 once: at most one bf16 step
            # (2^-7 of |y|) apart
            np.testing.assert_allclose(got.float().numpy(), want, atol=1e-6, rtol=2**-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_version_is_differentiable_and_the_kernel_is_not_asked(dtype):
    """Both implementations pair the forward with the reference's
    ``_rms_bwd`` formulas: the x and w gradients against ``jax.vjp`` of the
    reference's Pallas norm (its custom VJP, interpret mode), with dy·w
    formed in the input dtype as there; CPU tensors launch nothing."""
    rng = np.random.default_rng(5)
    xn = (2 * rng.standard_normal((3, 7, 96)) + 0.5).astype(np.float32)
    wn = (1 + 0.3 * rng.standard_normal(96)).astype(np.float32)
    dyn = rng.standard_normal((3, 7, 96)).astype(np.float32)
    tdt, jdt = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    _, pull = jax.vjp(lambda a, b: jax_ops.rmsnorm(a, b, impl="pallas", interpret=True),
                      jnp.asarray(xn, jdt), jnp.asarray(wn, jdt))
    want = [np.asarray(jnp.asarray(g, jnp.float32)) for g in pull(jnp.asarray(dyn, jdt))]
    for impl in ("auto", "torch"):
        x = torch.from_numpy(xn).to(tdt).requires_grad_(True)
        w = torch.from_numpy(wn).to(tdt).requires_grad_(True)
        got = torch.autograd.grad(ops.rmsnorm(x, w, impl=impl), (x, w),
                                  torch.from_numpy(dyn).to(tdt))
        for g, wv in zip(got, want):
            assert g.dtype == tdt
            if dtype == "float32":
                # the same fp32 formulas summed in another order
                np.testing.assert_allclose(g.numpy(), wv, atol=1e-5 * np.abs(wv).max(), rtol=0)
            else:
                # one rounding to bf16 of fp32 sums taken in another order:
                # within one bf16 step of each element's magnitude
                np.testing.assert_allclose(g.float().numpy(), wv, rtol=2 ** -7,
                                           atol=2 ** -8 * np.abs(wv).max())
    assert rmsnorm.launches == 0


@pytest.mark.parametrize("impl", ["auto", "torch"])
def test_rmsnorm_without_a_gradient_builds_no_autograd_node(impl):
    """``ops.rmsnorm`` calls the forward directly when no gradient is
    wanted: the same output as through ``rmsnorm_ad`` and no node; with
    ``requires_grad`` it goes through the autograd function, and under
    ``no_grad`` it does not."""
    from repro_torch.kernels.rmsnorm import rmsnorm_ad

    rng = np.random.default_rng(7)
    x = torch.from_numpy((2 * rng.standard_normal((4, 3, 64)) + 0.5).astype(np.float32)).bfloat16()
    w = torch.from_numpy((1 + 0.3 * rng.standard_normal(64)).astype(np.float32)).bfloat16()
    want = rmsnorm_ad(x, w, plain=impl == "torch")
    got = ops.rmsnorm(x, w, impl=impl)
    assert got.grad_fn is None and torch.equal(got, want)
    xg = x.clone().requires_grad_(True)
    tracked = ops.rmsnorm(xg, w, impl=impl)
    assert tracked.grad_fn is not None and torch.equal(tracked.detach(), want)
    with torch.no_grad():
        assert ops.rmsnorm(xg, w, impl=impl).grad_fn is None
    assert rmsnorm.launches == 0


def test_rmsnorm_argument_checks():
    """What the CUDA kernel does not take raises before a launch: dtype, a
    strided last dim, the weight's shape and layout, widths that are not a
    multiple of 8 or too wide, misaligned rows, another device."""
    from repro_torch.kernels.rmsnorm import check_rmsnorm_args

    x = torch.zeros(4, 64, dtype=torch.bfloat16)
    w = torch.ones(64, dtype=torch.bfloat16)
    check_rmsnorm_args(x, w)
    check_rmsnorm_args(x.float(), w)                       # w's dtype may differ from x's
    check_rmsnorm_args(torch.zeros(3, 5, 128)[:, 1:3], torch.ones(128))   # strided rows
    bad = [
        ((x.double(), w), TypeError),
        ((x, w.to(torch.int32)), TypeError),
        ((torch.zeros(4, 128, dtype=torch.bfloat16)[:, ::2], w), ValueError),   # last dim strided
        ((x, torch.ones(32, dtype=torch.bfloat16)), ValueError),                # weight shape
        ((x, torch.ones(64, 2, dtype=torch.bfloat16)[:, 0]), ValueError),       # weight strided
        ((torch.zeros(4, 60, dtype=torch.bfloat16), torch.ones(60)), ValueError),  # not 8k wide
        ((torch.zeros(2, 1 << 15, dtype=torch.bfloat16), torch.ones(1 << 15)), ValueError),
        ((torch.zeros(4, 68, dtype=torch.bfloat16)[:, :64], w), ValueError),    # 136-byte rows
        ((torch.zeros(4 * 64 + 1, dtype=torch.bfloat16)[1:].view(4, 64), w), ValueError),
        ((x, w.to("meta")), ValueError),
    ]
    for args, err in bad:
        with pytest.raises(err):
            check_rmsnorm_args(*args)
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm(x.to("meta"), w.to("meta"))


# ------------------------------------------------------------------ decode attention
# (B, T, H, Hkv, D, lengths, softcap): T is not a multiple of the reference
# kernel's 512-row blocks; lengths include 0, 1 and T
DECODE_CASES = {
    "group1": (3, 600, 2, 2, 64, [600, 0, 1], 0.0),
    "group2": (3, 37, 4, 2, 64, [1, 37, 20], 0.0),
    "group7": (2, 130, 7, 1, 128, [0, 130], 0.0),
    "group7_softcap": (3, 70, 14, 2, 64, [70, 1, 33], 5.0),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_attention_matches_pallas_flash_decode_and_xla(case, dtype):
    B, T, H, Hkv, D, lens, softcap = DECODE_CASES[case]
    rng = np.random.default_rng(1)
    q, jq = _pair(rng.standard_normal((B, 1, H, D)).astype(np.float32), dtype)
    k, jk = _pair(rng.standard_normal((B, T, Hkv, D)).astype(np.float32), dtype)
    v, jv = _pair(rng.standard_normal((B, T, Hkv, D)).astype(np.float32), dtype)
    lengths = np.asarray(lens, np.int32)
    got = fd.flash_decode(q, k, v, torch.from_numpy(lengths), softcap=softcap)
    assert got.dtype == q.dtype and got.shape == (B, 1, H, D)
    for want in (jax_flash_decode(jq, jk, jv, jnp.asarray(lengths), softcap=softcap,
                                  interpret=True),
                 jax_ops._decode_attention_xla(jq, jk, jv, jnp.asarray(lengths),
                                               softcap=softcap)):
        want = _np(want)
        err = np.abs(got.float().numpy() - want).max()
        # fp32: the same fp32 math in another order.  bf16: the Pallas
        # kernel keeps P in fp32 where the plain version (like the XLA
        # path) rounds the normalized P to bf16; both round the output once
        tol = 1e-5 if dtype == "float32" else 2e-2 * np.abs(want).max()
        assert err <= tol, (case, dtype, err)
    empty = lengths == 0
    assert (got[torch.from_numpy(empty)] == 0).all()   # idle slots give exactly zero
    assert torch.equal(ops.decode_attention(q, k, v, torch.from_numpy(lengths), softcap=softcap,
                                            impl="torch"), got)


def test_decode_attention_depends_only_on_each_rows_live_cache():
    """Rows past a row's length and the other rows do not move its output."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 64)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 50, 2, 64)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 50, 2, 64)).astype(np.float32))
    lengths = torch.tensor([20, 50], dtype=torch.int32)
    base = ops.decode_attention(q, k, v, lengths)
    k2, v2 = k.clone(), v.clone()
    k2[0, 20:], v2[0, 20:] = 1e3, -1e3
    k2[1], v2[1] = 0.0, 0.0
    assert torch.equal(ops.decode_attention(q, k2, v2, lengths)[0], base[0])


def test_flash_decode_argument_checks():
    q = torch.zeros(2, 1, 8, 64, dtype=torch.bfloat16)
    k = torch.zeros(2, 16, 2, 64, dtype=torch.bfloat16)
    ln = torch.zeros(2, dtype=torch.int32)
    fd.check_args(q, k, k, ln)
    bad = [
        ((q[:, :, :5], k, k, ln), ValueError),                                # H % Hkv
        ((torch.zeros(2, 1, 34, 64, dtype=torch.bfloat16), torch.zeros(2, 16, 2, 64, dtype=torch.bfloat16),
          torch.zeros(2, 16, 2, 64, dtype=torch.bfloat16), ln), ValueError),  # group 17
        ((q, k, k, ln.long()), ValueError),                                   # lengths dtype
        ((q.float(), k.float(), k.float(), ln), TypeError),
        ((torch.zeros(2, 1, 8, 96, dtype=torch.bfloat16), torch.zeros(2, 16, 2, 96, dtype=torch.bfloat16),
          torch.zeros(2, 16, 2, 96, dtype=torch.bfloat16), ln), ValueError),  # D 96
        ((torch.zeros(2, 2, 8, 64, dtype=torch.bfloat16), k, k, ln), ValueError),  # two queries
    ]
    for args, err in bad:
        with pytest.raises(err):
            fd.check_args(*args)
    with pytest.raises(ValueError, match="CUDA"):
        fd.flash_decode(q.to("meta"), k, k, ln)


# ------------------------------------------------------------------ sampling
def _sampling_inputs(seed=3, B=8, V=512):
    """Logits with masked columns and a mix of greedy, top-k only, top-p
    only, both, temperature 0 with filters set, and seeds past 2^31."""
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal((B, V))).astype(np.float32)
    x[:, rng.choice(V, size=V // 8, replace=False)] = -1e30
    x[1, :300] = -1e30
    params = [  # temperature, top_k, top_p, seed, step
        (0.0, 0, 1.0, 0, 0),
        (0.8, 50, 1.0, 1, 3),
        (1.0, 0, 0.9, 2**31 + 7, 11),
        (0.7, 20, 0.8, 2**32 - 1, 2**31 + 1),
        (0.0, 5, 0.5, 9, 2),
        (1.5, 0, 1.0, 12345, 0),
        (0.5, 1, 1.0, 77, 5),
        (1.0, 400, 0.99, 2**31, 4),
    ][:B]
    cols = list(zip(*params))
    return (x, np.asarray(cols[0], np.float32), np.asarray(cols[1], np.int32),
            np.asarray(cols[2], np.float32), np.asarray(cols[3], np.uint32),
            np.asarray(cols[4], np.uint32))


def _port_sample(x, temp, k, p, seed, step, impl="auto"):
    tok, logp = ops.sample_tokens(torch.from_numpy(x), torch.from_numpy(temp), torch.from_numpy(k),
                                  torch.from_numpy(p), torch.from_numpy(seed.astype(np.int64)),
                                  torch.from_numpy(step.astype(np.int64)), impl=impl)
    assert tok.dtype == torch.int32 and logp.dtype == torch.float32
    return tok.numpy(), logp.numpy()


@pytest.mark.parametrize("logits_dtype", ["float32", "bfloat16"])
def test_sampling_matches_pallas_fused_sample_and_xla(logits_dtype):
    x, temp, k, p, seed, step = _sampling_inputs()
    if logits_dtype == "bfloat16":   # the engine hands the sampler bf16 logits
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    tok, logp = _port_sample(x, temp, k, p, seed, step)
    args = [jnp.asarray(a) for a in (x, temp, k, p, seed, step)]
    for want_tok, want_logp in (jax_sampling.fused_sample(*args, interpret=True),
                                jax_sampling.sample_xla(*args)):
        np.testing.assert_array_equal(tok, np.asarray(want_tok))
        np.testing.assert_allclose(logp, np.asarray(want_logp), atol=1e-5, rtol=0)
    t2, l2 = _port_sample(x, temp, k, p, seed, step, impl="torch")
    assert np.array_equal(t2, tok) and np.array_equal(l2, logp)


def test_greedy_is_first_index_argmax_and_masked_columns_are_never_drawn():
    rng = np.random.default_rng(4)
    B, V = 64, 256
    x = rng.standard_normal((B, V)).astype(np.float32)
    masked = rng.choice(V, size=100, replace=False)
    x[:, masked] = -1e30
    x[:, 7] = x[:, 200] = 10.0          # a tie for the max: greedy takes column 7
    x[:, masked[0]] = -1e30
    greedy = np.zeros(B, np.float32)
    zeros, ones = np.zeros(B, np.int32), np.ones(B, np.float32)
    tok, logp = _port_sample(x, greedy, zeros, ones, np.arange(B, dtype=np.uint32),
                             np.zeros(B, np.uint32))
    assert (tok == 7).all()
    # greedy logp is under the full T=1 softmax over the valid columns
    xv = np.where(x > -5e29, x, -np.inf).astype(np.float64)
    want = xv[:, 7] - np.log(np.exp(xv).sum(-1))
    np.testing.assert_allclose(logp, want, atol=1e-5)
    # hot sampling with every filter off: never a masked column
    hot = np.full(B, 3.0, np.float32)
    x2 = x.copy()
    x2[:, [7, 200]] = 0.0
    tok, _ = _port_sample(x2, hot, zeros, ones, np.arange(B, dtype=np.uint32) * 7919,
                          np.arange(B, dtype=np.uint32))
    assert not np.isin(tok, masked).any() and len(set(tok.tolist())) > B // 4
    want_tok, _ = jax_sampling.sample_xla(*[jnp.asarray(a) for a in (
        x2, hot, zeros, ones, np.arange(B, dtype=np.uint32) * 7919, np.arange(B, dtype=np.uint32))])
    np.testing.assert_array_equal(tok, np.asarray(want_tok))


def test_counter_hash_is_bit_exact_on_a_grid_past_2_31():
    seeds = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1, 123456789], np.uint32)
    steps = np.array([0, 1, 7, 2**31, 2**32 - 1], np.uint32)
    idx = np.array([0, 1, 151999, 2**31 + 3, 2**32 - 1], np.uint32)
    S, T, I = np.meshgrid(seeds, steps, idx, indexing="ij")
    S, T, I = (a.reshape(-1, 1) for a in (S, T, I))
    # the reference's integer pipeline of gumbel_noise
    f = jax_sampling._fmix32
    h = f(jnp.asarray(S) + jnp.uint32(0x9E3779B9))
    h = f(h ^ (jnp.asarray(T) * jnp.uint32(0x85EBCA77)))
    want_bits = np.asarray(f(h ^ (jnp.asarray(I) * jnp.uint32(0x9E3779B1))))
    got_bits = ref.hash_bits(torch.from_numpy(S.astype(np.int64)), torch.from_numpy(T.astype(np.int64)),
                             torch.from_numpy(I.astype(np.int64)))
    np.testing.assert_array_equal(got_bits.numpy().astype(np.uint64), want_bits.astype(np.uint64))
    # int32 bit patterns (the engine's seed storage) hash the same
    got32 = ref.hash_bits(torch.from_numpy(S.view(np.int32)), torch.from_numpy(T.view(np.int32)),
                          torch.from_numpy(I.view(np.int32)))
    assert torch.equal(got32, got_bits)
    want_g = np.asarray(jax_sampling.gumbel_noise(jnp.asarray(S), jnp.asarray(T), jnp.asarray(I)))
    got_g = ref.gumbel_noise(torch.from_numpy(S.astype(np.int64)), torch.from_numpy(T.astype(np.int64)),
                             torch.from_numpy(I.astype(np.int64)))
    # the uniform is exact; -log(-log u) goes through two fp32 logs
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=1e-6, atol=1e-7)


def test_u32_bits_wraps_like_uint32():
    t = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 1, 2**32 + 5, -1])
    want = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1, 5, 2**32 - 1], np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(sp._u32_bits(t).numpy().view(np.uint32), want)


# (temperature, top_k, top_p) a row: ties at the top and at the k-th
# value, masked columns, k = 1, k >= V, a tiny p, temperatures 0.3-2, and
# a greedy row whose filters are set
LEVEL_ROWS = [(0.3, 0, 0.9), (0.7, 1, 1.0), (1.0, 50, 0.95), (2.0, 1000, 0.5),
              (1.3, 5000, 1.0), (0.5, 0, 1e-6), (1.0, 7, 0.8), (0.0, 3, 0.9)]


@pytest.fixture(scope="module")
def level_case():
    """bf16-valued logits and the reference's tokens, logp and bisection
    thresholds (lo_k, lo_p), the thresholds read out of ``_sample_rows``'s
    own fori_loop by a debug callback."""
    rng = np.random.default_rng(23)
    B, V = len(LEVEL_ROWS), 1000
    x = (2.0 * rng.standard_normal((B, V))).astype(np.float32)
    x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    x[:, rng.choice(V, size=120, replace=False)] = -1e30
    for b in (0, 7):                                           # a three-way tie at the top
        x[b, [10, 20, 30]] = x[b].max() + 1.0
    for b, kth in ((2, 50), (6, 7)):                           # ties at the k-th value
        top = np.sort(x[b][x[b] > -5e29])[::-1]
        x[b, 100:105] = top[kth - 2]
    temp, k, p = (np.asarray(c, dt) for c, dt in zip(zip(*LEVEL_ROWS),
                                                    (np.float32, np.int32, np.float32)))
    seed = (np.arange(B, dtype=np.uint64) * 7919 + 2**31).astype(np.uint32)
    step = np.arange(B, dtype=np.uint32) * 3
    orig, got = jax.lax.fori_loop, []

    def spy(lo, hi, body, init):
        out = orig(lo, hi, body, init)
        jax.debug.callback(lambda *a: got.append([np.asarray(v) for v in a]), *out)
        return out

    jax.lax.fori_loop = spy
    try:
        tok, logp = jax_sampling.sample_xla(*[jnp.asarray(a) for a in (x, temp, k, p, seed, step)])
        tok, logp = np.asarray(tok), np.asarray(logp)
    finally:
        jax.lax.fori_loop = orig
    assert len(got) == 1
    lo_k, _, lo_p, _ = (a[:, 0] for a in got[0])
    return (x, temp, k, p, seed, step), (tok, logp, lo_k, lo_p)


def _kept(x, temp, lo_k, lo_p):
    """The reference's kept set from its thresholds, in fp32."""
    valid = x > -5e29
    greedy = temp <= 0
    z = np.where(valid, x / np.where(greedy, 1.0, temp).astype(np.float32)[:, None], -1e30)
    m = z.max(-1)
    mn = np.where(valid, z, m[:, None]).min(-1)
    tau = np.where(greedy, mn, np.minimum(np.maximum(lo_k, lo_p), m))
    return valid & (z >= tau[:, None])


@pytest.mark.parametrize("levels", [1, 3, 4, 5])
def test_bisection_walked_levels_a_pass_is_the_references(level_case, levels):
    """The kernel's walk of the bisection, ``levels`` steps a pass, against
    the reference's 32 sequential steps: the top-k threshold bit for bit,
    the kept set and the token equal, logp within 1e-4."""
    (x, temp, k, p, seed, step), (want_tok, want_logp, want_lo_k, want_lo_p) = level_case
    tok, logp, lo_k, lo_p = ref.sample_levels_ref(
        torch.from_numpy(x), torch.from_numpy(temp), torch.from_numpy(k), torch.from_numpy(p),
        torch.from_numpy(seed.astype(np.int64)), torch.from_numpy(step.astype(np.int64)), levels)
    np.testing.assert_array_equal(lo_k.numpy().view(np.uint32), want_lo_k.view(np.uint32))
    np.testing.assert_array_equal(_kept(x, temp, lo_k.numpy(), lo_p.numpy()),
                                  _kept(x, temp, want_lo_k, want_lo_p))
    np.testing.assert_array_equal(tok.numpy(), want_tok)
    np.testing.assert_allclose(logp.numpy(), want_logp, atol=1e-4, rtol=0)
    assert (tok.numpy()[temp <= 0] == 10).all()                # greedy: the first of the tie


def test_fused_sample_argument_checks():
    B = 3
    t, p = torch.ones(B), torch.ones(B)
    k, s = torch.zeros(B, dtype=torch.int32), torch.zeros(B, dtype=torch.int32)
    for V in (1, 999, 152064, 202240, 600000):     # any V: a slice past shared memory streams
        sp.check_args(torch.zeros(B, V, dtype=torch.bfloat16), t, k, p, s, s)
    x = torch.zeros(B, 1000, dtype=torch.bfloat16)
    bad = [
        (x.float(), t, k, p, s, s),                     # fp32 logits
        (x[:, ::2], t, k, p, s, s),                     # strided vocab dim
        (x[None], t, k, p, s, s),                       # 3-D
        (torch.zeros(B, 0, dtype=torch.bfloat16), t, k, p, s, s),   # empty vocabulary
        (x, t[:2], k, p, s, s),                         # a short per-row vector
        (x, t, k[:, None], p, s, s),                    # a 2-D per-row vector
    ]
    for args in bad:
        with pytest.raises(ValueError):
            sp.check_args(*args)
    with pytest.raises(ValueError, match="CUDA"):
        sp.fused_sample(x.to("meta"), t, k, p, s, s)


def test_cpu_dispatch_launches_no_generation_kernel():
    x, temp, k, p, seed, step = _sampling_inputs(B=2, V=64)
    _port_sample(x, temp, k, p, seed, step)
    q = torch.zeros(1, 1, 2, 64)
    ops.decode_attention(q, torch.zeros(1, 4, 1, 64), torch.zeros(1, 4, 1, 64),
                         torch.tensor([2], dtype=torch.int32))
    ops.rmsnorm(torch.ones(2, 8), torch.ones(8))
    assert fd.flash_decode.launches == sp.fused_sample.launches == rmsnorm.launches == 0
