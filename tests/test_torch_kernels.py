"""The port's kernel ops on the CPU (their plain PyTorch versions) against
the reference's TPU kernels run in Pallas interpret mode, on the same
seeded numpy inputs; plus the kernel wrappers' argument checks, the host
side of the attention kernels' schedule (tensor maps, work items, the key
tiles a query tile streams, the masked tiles) and the CPU dispatch."""
import ast
import inspect
import itertools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import flash_attention_fwd as jax_flash_attention_fwd  # noqa: E402
from repro.kernels.rmsnorm import layernorm as jax_layernorm  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
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
    # what the TMA copies take: strides that are positive multiples of 16
    # bytes below 2^40 and a 16-byte-aligned start; q, k, v read through a
    # fused QKV projection's view and a (B, H, S, D) layout's transpose take
    qkv = t(2, 8, 3, 4, 64)
    check_args(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    check_args(*[t(2, 4, 8, 64).transpose(1, 2)] * 3)
    check_args(*[t(1, 8, 4, 64)[:, :, None, 0].expand(1, 8, 1, 64)] * 3)  # size-1 dims, any stride
    with pytest.raises(ValueError, match="positive multiple"):
        check_args(t(1, 8, 4, 64).expand(2, 8, 4, 64), t(2, 8, 4, 64), t(2, 8, 4, 64))
    with pytest.raises(ValueError, match="positive multiple"):
        check_args(t(2, 8, 4, 64), t(2, 8, 4, 68)[..., :64], t(2, 8, 4, 64))
    with pytest.raises(ValueError, match="16-byte aligned"):
        check_args(t(2 * 8 * 4 * 64 + 8)[1:-7].view(2, 8, 4, 64), t(2, 8, 4, 64), t(2, 8, 4, 64))
    huge = torch.empty_strided((2, 8, 4, 64), (1 << 40, 256, 64, 1), dtype=torch.bfloat16,
                               device="meta")
    with pytest.raises(ValueError, match="below 2\\^40"):
        check_args(huge, t(2, 8, 4, 64), t(2, 8, 4, 64))
    with pytest.raises(ValueError, match="no empty operand"):
        check_args(t(2, 0, 4, 64), t(2, 8, 4, 64), t(2, 8, 4, 64))


def _layouts():
    """(B, L, heads, D) bf16 views the kernels take: contiguous, a fused
    projection's slice, a head-major layout's transpose, a size-1 batch."""
    z = torch.zeros
    return {"contiguous": z(2, 40, 4, 64, dtype=torch.bfloat16),
            "fused_qkv_slice": z(2, 40, 3, 4, 128, dtype=torch.bfloat16)[:, :, 1],
            "head_major": z(2, 4, 40, 64, dtype=torch.bfloat16).transpose(1, 2),
            "size1_batch": z(40, 4, 128, dtype=torch.bfloat16)[None]}


@pytest.mark.parametrize("layout", list(_layouts()))
def test_tensor_map_geometry_addresses_every_element(layout):
    t = _layouts()[layout]
    D, L, N, B, s_l, s_n, s_b = fa.tma_geometry(t)
    assert (B, L, N, D) == tuple(t.shape)
    assert all(s > 0 and s % 16 == 0 and s < 1 << 40 for s in (s_l, s_n, s_b))
    es = t.element_size()
    for b, i, h, d in itertools.product(range(B), (0, 1, L - 1), range(N), (0, D - 1)):
        # the map's address of element (d, i, h, b) is the tensor's own
        assert (t.data_ptr() + d * es + i * s_l + h * s_n + b * s_b
                == t[b, i, h, d:].data_ptr()), (b, i, h, d)
    check_args(t, t, t)


# (query tiles, b*heads) of work items: ESM-2's serving and Qwen2's prefill,
# a ragged tile count, more items than SMs and fewer
ITEM_SHAPES = [(8, 640), (8, 28), (3, 5), (1, 1), (16, 80)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", ITEM_SHAPES)
def test_work_items_cover_every_tile_once_heaviest_first(shape, causal):
    n_tiles, heads = shape
    items = fa.work_items(n_tiles, heads, causal, heavy_last=True)
    assert sorted(items) == sorted(itertools.product(range(n_tiles), range(heads)))
    grid = fa.grid_blocks(len(items), 132)
    taken = [items[i] for blk in range(grid) for i in range(blk, len(items), grid)]
    assert sorted(taken) == sorted(items)                  # the persistent blocks take each once
    if causal:                                             # query tiles never get heavier
        assert all(a[0] >= b[0] for a, b in zip(items, items[1:]))
        assert items[0][0] == n_tiles - 1
        back = fa.work_items(n_tiles, heads, causal, heavy_last=False)
        assert all(a[0] <= b[0] for a, b in zip(back, back[1:]))
    else:                                                  # one head's tiles side by side
        assert items[:n_tiles] == [(i, 0) for i in range(n_tiles)]


# (S, T, causal, window, q_offset): a square causal prefill, a window
# inside and across tiles, an offset query block (a decode chunk), ragged
# tails, rows with no key, and none visible at all
MASKS = [(256, 256, True, 0, 0), (300, 300, True, 100, 0), (200, 333, False, 0, 0),
         (40, 104, True, 0, 64), (130, 400, True, 64, 200), (24, 24, True, 0, -8),
         (16, 130, True, 0, -200), (77, 131, False, 0, 0)]


def _visible(i, j, S, T, causal, window, q_offset):
    qpos = i + q_offset
    return (i < S and j < T and (not causal or j <= qpos)
            and (window <= 0 or j > qpos - window))


@pytest.mark.parametrize("keys", sorted({*fa.FWD_KEYS.values(), fa.BWD_ROWS}))
@pytest.mark.parametrize("mask", MASKS)
def test_key_tiles_hold_every_visible_key_and_unmasked_tiles_are_all_visible(mask, keys):
    S, T, causal, window, q_offset = mask
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    for q0 in range(0, S, fa.TILE):
        tiles = fa.key_tiles(q0, S, T, keys=keys, **kw)
        streamed = {j for k0 in tiles for j in range(k0, k0 + keys)}
        rows = range(q0, min(q0 + fa.TILE, S))
        seen = {j for i in rows for j in range(T) if _visible(i, j, S, T, **kw)}
        assert seen <= streamed                                # no visible key is skipped
        for k0 in tiles:                                       # and no tile is all masked ...
            assert any(_visible(i, j, S, T, **kw) for i in rows for j in range(k0, k0 + keys)) \
                or not seen
            if not fa.needs_mask(q0, fa.TILE, k0, keys, S, T, **kw):   # ... or wrongly unmasked
                assert all(_visible(i, j, S, T, **kw)
                           for i in range(q0, q0 + fa.TILE) for j in range(k0, k0 + keys))


def test_attention_kernel_route_calls_no_library_attention_or_product():
    """The wrappers hand every product to the hand-written kernels: no SDPA,
    matmul, softmax or einsum in the module outside the plain versions,
    which they call only for CPU tensors and which live in ``ref.py``."""
    banned = {"scaled_dot_product_attention", "matmul", "mm", "bmm", "einsum", "softmax",
              "log_softmax", "logsumexp", "baddbmm"}
    tree = ast.parse(inspect.getsource(fa))
    for node in ast.walk(tree):
        assert not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult))
        assert not (isinstance(node, ast.Attribute) and node.attr in banned), node.attr
    wrappers = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        src = ast.unparse(wrappers[name])
        # the plain version only behind the CPU test, then the kernel or a raise
        assert src.count("_ref(") == 1 and "if q.device.type == 'cpu':" in src, name
        assert "try:" not in src and "except" not in src, name
