"""The port's backward ops on the CPU (their plain PyTorch versions) against
the reference's TPU kernels in Pallas interpret mode, on the same seeded
numpy inputs: the flash-attention backward, the fused cross-entropy forward
and backward, and the LayerNorm backward; plus the differentiable ops'
autograd wiring, the wrappers' argument checks, the cross-entropy kernels'
schedule (vocab splits, chunks, token shares) and the CPU dispatch."""
import ast
import inspect
import re

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
    # (T, D, Vpad, vocab, block_v, tied): vocab < Vpad, a ragged token tail,
    # several vocab blocks with one fully padded, a vocab that ends inside
    # the kernels' 128-column tile with targets in that last live tile, and
    # the tied head's layout (w the transposed view of a (Vpad, D) table)
    "padded_vocab": (100, 64, 256, 33, 128, False),
    "multi_block": (70, 32, 384, 300, 128, False),
    "vocab_mid_tile": (90, 48, 384, 200, 128, False),
    "tied": (100, 64, 256, 33, 128, True),
}


def _ce_inputs(case, dtype, seed):
    T, D, Vp, vocab, bv, tied = CE_CASES[case]
    h, w, gl, gs = _arrays([(T, D), (D, Vp), (T,), (T,)], seed)
    w *= 0.3
    rng = np.random.default_rng(seed + 1)
    tgt = rng.integers(0, vocab, size=T).astype(np.int32)
    if case == "vocab_mid_tile":                     # a third of them in the last live tile
        tgt[::3] = rng.integers(vocab // 128 * 128, vocab, size=len(tgt[::3]))
    gl, gs = np.abs(gl) / T, 0.1 * gs / T            # nonzero g_lse
    th, jh = _pair(h, dtype)
    tw, jw = _pair(w, dtype)
    if tied:
        tw = tw.T.contiguous().T
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


# (T, D, vocab) the kernels' schedule is set for: ESM-2 and Llama-4-Scout
# training, a ragged T, Qwen2's vocabulary, one token, a long batch
SCHEDULE_SHAPES = {"esm2": (8192, 1280, 33), "scout": (2048, 5120, 202048),
                   "ragged": (1000, 1280, 33), "qwen2": (4096, 3584, 152064),
                   "one_token": (1, 5120, 202048), "long": (100000, 1280, 50280)}


@pytest.mark.parametrize("shape", list(SCHEDULE_SHAPES))
def test_vocab_splits_give_two_waves_and_stop_at_the_last_live_tile(shape):
    T, _, vocab = SCHEDULE_SHAPES[shape]
    n_live = ce.live_tiles(vocab)
    assert (n_live - 1) * 128 < vocab <= n_live * 128
    splits, per = ce.vocab_splits(T, vocab)
    # the kernel's split s walks tiles [s per, min(n_live, (s + 1) per)):
    # every split has a live tile and the last one ends at the last live tile
    assert (splits - 1) * per < n_live <= splits * per
    blocks = -(-T // 128) * splits
    assert blocks >= 2 * ce._SMS or splits == n_live        # two waves, or a split a tile
    if shape == "scout":
        assert (splits, per) == (132, 12) and blocks == 16 * ce._SMS
    if shape == "esm2":
        assert (splits, per) == (1, 1)                       # 33 live columns: one tile of 2


@pytest.mark.parametrize("shape", list(SCHEDULE_SHAPES))
def test_chunk_width_bounds_the_dlogits_and_covers_each_live_column_once(shape):
    T, _, vocab = SCHEDULE_SHAPES[shape]
    per = ce.chunk_tiles(T, vocab)
    assert T * per * 128 * 2 <= ce._DLOGITS_BYTES or per == 1
    n_live = ce.live_tiles(vocab)
    covered = []
    for t0 in range(0, n_live, per):                          # the kernel's chunk loop
        covered += range(t0 * 128, (t0 + min(per, n_live - t0)) * 128)
    assert covered == list(range(n_live * 128))               # each live column once, in order
    if shape == "scout":
        assert per == 395 and -(-n_live // per) == 4          # 4 chunks of 207 MB
    if shape == "esm2":
        assert per == 1


@pytest.mark.parametrize("shape", list(SCHEDULE_SHAPES))
def test_dw_token_shares_cover_every_token_tile_once(shape):
    T, D, vocab = SCHEDULE_SHAPES[shape]
    out_tiles = ce.chunk_tiles(T, vocab) * -(-D // 128)
    shares, per = ce.dw_token_shares(out_tiles, T)
    assert per % 64 == 0                                       # whole k-slices
    covered = [t for z in range(shares) for t in range(z * per, min(T, (z + 1) * per))]
    assert covered == list(range(T))                           # every token once, in share order
    steps = -(-T // 64)
    if out_tiles >= ce._SMS:
        assert shares == 1
    else:                                      # within one wave, and more than half of one
        assert out_tiles * shares <= ce._SMS
        assert 2 * out_tiles * shares > ce._SMS or shares == steps
    if shape == "esm2":
        assert (shares, per) == (13, 640)                      # 10 tiles -> 130 blocks
    if shape == "scout":
        assert shares == 1                                     # 15 800 tiles fill the card


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
    # w is read where it lies: neither layout contiguous, a stride or a
    # start that 16-byte copies cannot take, an untied Vpad not a multiple of 8
    with pytest.raises(ValueError, match="must be contiguous"):
        ce.check_args(t(8, 64), t(64, 512)[:, ::2], tgt)
    with pytest.raises(ValueError, match="16-byte copies"):
        ce.check_args(t(8, 64), t(64, 260)[:, :256], tgt)
    with pytest.raises(ValueError, match="16-byte copies"):
        ce.check_args(t(8, 64), t(64, 257)[:, 1:], tgt)
    with pytest.raises(ValueError, match="16-byte copies"):
        ce.check_args(t(8, 64), t(64, 252), tgt)
    with pytest.raises(ValueError, match="16-byte copies"):
        ce.check_args(t(8, 64), t(256, 68)[:, :64].T, tgt)


def test_cross_entropy_kernel_route_calls_no_library_product():
    """The wrappers hand every product to the hand-written kernels: no
    matmul, no library loss and no copy of w in the module; the plain
    versions, which they call only for CPU tensors, live in ``ref.py``."""
    banned = {"matmul", "mm", "bmm", "einsum", "cross_entropy", "log_softmax", "logsumexp"}
    tree = ast.parse(inspect.getsource(ce))
    wrappers = [n for n in tree.body if isinstance(n, ast.FunctionDef)
                and n.name in ("cross_entropy_fwd", "cross_entropy_bwd")]
    assert len(wrappers) == 2
    for fn in wrappers:
        for node in ast.walk(fn):
            assert not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult))
            assert not (isinstance(node, ast.Attribute) and node.attr in banned), node.attr
        assert not re.search(r"\bw\.(t\(|T\b|contiguous|transpose)", ast.unparse(fn)), fn.name


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
    # dO and out go through the same TMA and 16-byte-copy rules as q, k, v
    with pytest.raises(ValueError, match="dO: .*positive multiple"):
        fa.check_args(q, k, k, q, t(1, 8, 4, 64).expand(2, 8, 4, 64))
    with pytest.raises(ValueError, match="out: .*16-byte aligned"):
        fa.check_args(q, k, k, t(2 * 8 * 4 * 64 + 8)[4:-4].view(2, 8, 4, 64), q)
    fa.check_args(q, k, k, t(2, 4, 8, 64).transpose(1, 2), t(2, 4, 8, 64).transpose(1, 2))


# (S, T, causal, window, q_offset) of the dK/dV pass's schedule: a square
# causal training step, a window across tiles, a ragged GQA shape, an
# offset query block, rows with no key, none visible at all
DKV_MASKS = [(256, 256, True, 0, 0), (300, 300, True, 100, 0), (200, 333, False, 0, 0),
             (40, 104, True, 0, 64), (24, 24, True, 0, -8), (16, 130, True, 0, -200)]


@pytest.mark.parametrize("mask", DKV_MASKS)
def test_query_tiles_hold_every_query_that_sees_the_key_tile(mask):
    S, T, causal, window, q_offset = mask
    kw = dict(causal=causal, window=window, q_offset=q_offset)

    def visible(i, j):
        qpos = i + q_offset
        return (i < S and j < T and (not causal or j <= qpos)
                and (window <= 0 or j > qpos - window))

    for k0 in range(0, T, fa.TILE):
        tiles = fa.query_tiles(k0, S, **kw)
        streamed = {i for q0 in tiles for i in range(q0, q0 + fa.BWD_ROWS)}
        keys = range(k0, min(k0 + fa.TILE, T))
        assert {i for i in range(S) for j in keys if visible(i, j)} <= streamed
        for q0 in tiles:
            if not fa.needs_mask(q0, fa.BWD_ROWS, k0, fa.TILE, S, T, **kw):
                assert all(visible(i, j) for i in range(q0, q0 + fa.BWD_ROWS)
                           for j in range(k0, k0 + fa.TILE))


@pytest.mark.parametrize("shape", [(8, 160), (8, 16), (3, 4)])
def test_dkv_work_items_take_the_heaviest_key_tile_first(shape):
    """The dK/dV pass's items: every (key tile, b*hkv) once; under causal
    masking the first key tiles, which most query tiles see, come first."""
    n_tiles, heads = shape
    items = fa.work_items(n_tiles, heads, True, heavy_last=False)
    assert sorted(items) == sorted((t, h) for t in range(n_tiles) for h in range(heads))
    work = [len(fa.query_tiles(t * fa.TILE, n_tiles * fa.TILE, causal=True, window=0, q_offset=0))
            for t, _ in items]
    assert work == sorted(work, reverse=True)


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


# (rows, d, sms): the backward kernel's block partition on a grid for one
# SM with a tail (61 rows: 5 blocks of 11, the last of 6) and without (60
# rows: 6 of 10), and on the kernel's own grid with a tail (8704 rows: 2902
# blocks of 3, the last of 1) and without (9216 rows: 3072 of 3)
LN_BWD_PARTITIONS = {"tail": (61, 1280, 1), "even": (60, 1280, 1),
                     "kernel grid, tail": (8704, 64, ref.LN_BWD_SMS),
                     "kernel grid, even": (9216, 64, ref.LN_BWD_SMS)}


def test_layernorm_bwd_blocks_partition_the_rows():
    assert ref.layernorm_bwd_blocks(61, 1280, 1) == (6, 11)
    assert ref.layernorm_bwd_blocks(60, 1280, 1) == (6, 10)
    assert ref.layernorm_bwd_blocks(8704, 64) == (2902, 3)
    assert ref.layernorm_bwd_blocks(9216, 64) == (3072, 3)
    # ESM-2's, Geneformer's and MolMIM's training shapes: the blocks an
    # H100 holds at once (6, 10 and 16 an SM), ~1 M fp32 partials an array
    assert ref.layernorm_bwd_blocks(8192, 1280) == (745, 11)
    assert ref.layernorm_bwd_blocks(16384, 768) == (1261, 13)
    assert ref.layernorm_bwd_blocks(16384, 512) == (2048, 8)
    assert ref.layernorm_bwd_blocks(512, 8192) == (128, 4)       # one block an SM
    for rows, d in ((1, 8), (7, 8192), (100_000, 2560), (513, 4096)):
        G, R = ref.layernorm_bwd_blocks(rows, d)
        assert (G - 1) * R < rows <= G * R


def test_layernorm_bwd_workspace_holds_every_grid():
    # the wrapper's one workspace a card (layernorm_bwd_workspace in
    # csrc/layernorm.cu: two arrays of SMs x resident threads x 8 fp32
    # partials) holds the partials of every width the backward takes, at
    # row counts below, at and past the grid's largest
    ws = 2 * ref.LN_BWD_SMS * ref.LN_BWD_RESIDENT * 8
    for d in range(8, 8192 + 1, 8):
        for rows in (1, 7, 1000, 4224, 65_537, 1_000_003):
            G, _ = ref.layernorm_bwd_blocks(rows, d)
            assert 2 * G * d <= ws, (rows, d, G)
    assert 2 * ref.layernorm_bwd_blocks(10**6, 8192)[0] * 8192 == ws


LN_BWD_SCHEDULE_CASES = [
    (bias, dtypes, part) for part in ("tail", "even") for bias in (True, False)
    for dtypes in ("float32", "bfloat16", "bfloat16 x, float32 w")
] + [(True, "float32", "kernel grid, tail"), (False, "bfloat16", "kernel grid, tail"),
     (True, "bfloat16 x, float32 w", "kernel grid, even"), (False, "float32", "kernel grid, even")]


@pytest.mark.parametrize("bias,dtypes,part", LN_BWD_SCHEDULE_CASES)
def test_layernorm_bwd_schedule_matches_jax_vjp(bias, dtypes, part, monkeypatch):
    """The plain function that follows the backward kernel's schedule
    (``ref.layernorm_bwd_sched_ref``: blocks of rows with a tail and
    without, each column's partials in row order, the blocks summed in
    order by segments, dy·w in the promoted dtype) against ``jax.vjp`` of
    the reference's ``ops.layernorm`` through its Pallas kernel in
    interpret mode."""
    rows, d, sms = LN_BWD_PARTITIONS[part]
    monkeypatch.setenv("REPRO_FORCE_IMPL", "pallas_interpret")
    x, w, b, dy = _arrays([(rows, d), (d,), (d,), (rows, d)], 32)
    x = 3 * x + 1
    w, b = 1 + 0.1 * w, 0.1 * b
    xdt = "float32" if dtypes == "float32" else "bfloat16"
    wdt = "bfloat16" if dtypes == "bfloat16" else "float32"
    (tx, jx), (tdy, jdy) = _pair(x, xdt), _pair(dy, xdt)
    (tw, jw), (tb, jb) = _pair(w, wdt), _pair(b, wdt)
    args = (jx, jw, jb) if bias else (jx, jw)
    _, vjp = jax.vjp(lambda *a: jax_ops.layernorm(*a), *args)
    want = vjp(jdy)
    tb = tb if bias else None
    dx, dw, db = ref.layernorm_bwd_sched_ref(tx, tw, tb, tdy, sms=sms)
    assert dx.dtype == tx.dtype and dw.dtype == tw.dtype and (db is None) == (not bias)
    plain = ref.layernorm_bwd_ref(tx, tw, tb, tdy)
    assert torch.equal(dx, plain[0])          # the same per-row formulas
    # dx: one rounding to x's dtype (GRAD_TOL); dw and db: fp32 sums of the
    # same fp32 terms in another order (up to 6144 rows), rounded once to
    # w's dtype
    tol = {"float32": dict(atol=1e-4, rtol=1e-5), "bfloat16": GRAD_TOL["bfloat16"]}
    _close(dx, want[0].astype(jnp.float32), tol[xdt])
    for g, w_, p in zip((dw, db) if bias else (dw,), want[1:], plain[1:]):
        _close(g, w_.astype(jnp.float32), tol[wdt])
        _close(g, p.float().numpy(), tol[wdt])


def test_layernorm_bwd_schedule_sums_in_the_kernels_order():
    """Each block's partials are the fp32 running sums of its rows, in row
    order, and the blocks' sums come in segments: the schedule's dw and db
    are the nested loops', bit for bit."""
    rows, d, sms = LN_BWD_PARTITIONS["tail"]
    x, w, dy = (torch.from_numpy(a) for a in _arrays([(rows, d), (d,), (rows, d)], 33))
    _, dw, db = ref.layernorm_bwd_sched_ref(x, w, w, dy, sms=sms)
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xhat = (xf - mu) * torch.rsqrt(((xf - mu) ** 2).mean(-1, keepdim=True) + 1e-5)
    G, R = ref.layernorm_bwd_blocks(rows, d, sms)
    seg = -(-G // ref.LN_BWD_SUM_SEGS)
    for got, terms in ((dw, dy * xhat), (db, dy)):
        parts = []
        for g in range(G):
            acc = torch.zeros(d)
            for r in range(g * R, min(rows, (g + 1) * R)):
                acc = acc + terms[r]
            parts.append(acc)
        total = torch.zeros(d)
        for s in range(ref.LN_BWD_SUM_SEGS):
            acc = torch.zeros(d)
            for g in range(s * seg, min(G, (s + 1) * seg)):
                acc = acc + parts[g]
            total = total + acc
        assert torch.equal(got, total)


def test_layernorm_argument_checks():
    """What the CUDA kernels do not take raises before a launch: dtypes, a
    strided last dim, the weights' shapes and layouts, widths that are not
    a multiple of 8 or too wide (16384 forward, 8192 backward), misaligned
    rows, another device, a dy unlike x."""
    from repro_torch.kernels.rmsnorm import check_layernorm_args, layernorm_bwd

    x = torch.zeros(4, 64, dtype=torch.bfloat16)
    w = torch.ones(64, dtype=torch.bfloat16)
    check_layernorm_args(x, w)
    check_layernorm_args(x, w.float(), w.half())                   # each its own dtype
    check_layernorm_args(x.half(), w, None, x.half())              # the backward's
    check_layernorm_args(torch.zeros(3, 5, 128)[:, 1:3], torch.ones(128))   # strided rows
    check_layernorm_args(torch.zeros(2, 1 << 14), torch.ones(1 << 14))       # widest forward
    bad = [
        ((x.double(), w), TypeError),
        ((x, w.to(torch.int32)), TypeError),
        ((x, w, w.double()), TypeError),
        ((torch.zeros(4, 128, dtype=torch.bfloat16)[:, ::2], w), ValueError),   # last dim strided
        ((x, torch.ones(32, dtype=torch.bfloat16)), ValueError),                # weight shape
        ((x, w, torch.ones(32)), ValueError),                                   # bias shape
        ((x, torch.ones(64, 2, dtype=torch.bfloat16)[:, 0]), ValueError),       # weight strided
        ((torch.zeros(4, 60, dtype=torch.bfloat16), torch.ones(60)), ValueError),  # not 8k wide
        ((torch.zeros(2, 1 << 15, dtype=torch.bfloat16), torch.ones(1 << 15)), ValueError),
        ((torch.zeros(4, 68, dtype=torch.bfloat16)[:, :64], w), ValueError),    # 136-byte rows
        ((torch.zeros(4 * 64 + 1, dtype=torch.bfloat16)[1:].view(4, 64), w), ValueError),
        ((x, w.to("meta")), ValueError),
        ((x, w, w.to("meta")), ValueError),
        ((x, w, None, x.float()), ValueError),                                  # dy's dtype
        ((x, w, None, x[:2]), ValueError),                                      # dy's shape
        ((torch.zeros(2, 1 << 14), torch.ones(1 << 14), None, torch.zeros(2, 1 << 14)),
         ValueError),                                                           # backward width
    ]
    for args, err in bad:
        with pytest.raises(err):
            check_layernorm_args(*args)
    with pytest.raises(ValueError, match="CUDA"):
        layernorm(x.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        layernorm_bwd(x.to("meta"), w.to("meta"), None, x.to("meta"))


def test_ops_layernorm_without_a_gradient_builds_no_node():
    """Serving and ``torch.no_grad`` call the forward directly: no autograd
    node, the same output as through the autograd Function."""
    x, w, b = (torch.from_numpy(a) for a in _arrays([(3, 5, 64), (64,), (64,)], 34))
    for impl in ("auto", "torch"):
        want = ops.layernorm(x, w.requires_grad_(True), b, impl=impl)
        assert want.grad_fn is not None
        w.requires_grad_(False)
        got = ops.layernorm(x, w, b, impl=impl)
        assert got.grad_fn is None and torch.equal(got, want.detach())
        with torch.no_grad():
            got = ops.layernorm(x.requires_grad_(True), w, b, impl=impl)
        x.requires_grad_(False)
        assert got.grad_fn is None and torch.equal(got, want.detach())
        assert ops.layernorm(x, w, b.requires_grad_(True), impl=impl).grad_fn is not None
        b.requires_grad_(False)


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
