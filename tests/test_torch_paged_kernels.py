"""The paged-KV kernel ops on the CPU — decode and chunk-prefill attention
through a block table, the per-token K/V insert and the decode step's
insert fused into the decode, their plain PyTorch versions — against the
reference's TPU kernels run in Pallas interpret mode and against its XLA
paths, on the same seeded numpy inputs; plus the chunk row scatter, the
fused insert's writer choice, the kernel wrappers' argument checks, and no
kernel launch on the CPU."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import paged_attention as jax_pa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels.flash_attention import FWD_KEYS, TILE  # noqa: E402
from repro_torch.models.attention import paged_decode_addressing  # noqa: E402

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
BF16_STEP = 2.0**-7     # the largest relative spacing of bf16 values


def _pair(a, dtype):
    return torch.from_numpy(a).to(TDT[dtype]), jnp.asarray(a, JDT[dtype])


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pool_and_table(rng, B, P, page, Hkv, D, lengths, n_tables):
    """Pools of P pages (page 0 is the null page) and a block table whose
    rows map disjoint, shuffled pages up to each row's length and the null
    page past it."""
    k = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    table = np.zeros((B, n_tables), np.int32)
    free = list(rng.permutation(np.arange(1, P)))
    for b, L in enumerate(lengths):
        n = -(-int(L) // page)
        table[b, :n] = [free.pop() for _ in range(n)]
    return k, v, table


def _check_attention(got, want_pallas, want_xla, dtype, what):
    got = got.float().numpy()
    for name, want in (("pallas", _np(want_pallas)), ("xla", _np(want_xla))):
        err = np.abs(got - want)
        if dtype == "float32":
            # the same fp32 math, summed in another order
            assert err.max() <= 1e-5, (what, name, err.max())
        elif name == "xla":
            # the same math and roundings as the XLA path: within two bf16
            # steps of each value
            assert (err <= 1e-6 + 2 * BF16_STEP * np.abs(want)).all(), (what, name, err.max())
        else:
            # the Pallas kernel keeps P in fp32 where the plain version (as
            # the XLA path) rounds the normalized P to bf16: within two bf16
            # steps of the output's scale
            assert err.max() <= 2 * BF16_STEP * np.abs(want).max(), (what, name, err.max())


# ------------------------------------------------------------------ decode
# (B, H, Hkv, D, page, n_tables, lengths, softcap): ragged lengths that are
# not page multiples, length 0, null-page entries past each length
DECODE_CASES = {
    "page8_group1": (4, 2, 2, 64, 8, 9, [70, 0, 1, 33], 0.0),
    "page16_group7": (3, 7, 1, 128, 16, 5, [80, 17, 0], 0.0),
    "page16_group7_softcap": (3, 14, 2, 64, 16, 4, [64, 5, 40], 20.0),
    "page8_group2_softcap": (2, 4, 2, 64, 8, 6, [0, 41], 20.0),
    "page32_group4": (2, 8, 2, 64, 32, 3, [70, 33], 0.0),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_paged_decode_matches_pallas_and_xla(case, dtype):
    B, H, Hkv, D, page, n, lens, softcap = DECODE_CASES[case]
    rng = np.random.default_rng(1)
    kp, vp, table = _pool_and_table(rng, B, 2 + B * n, page, Hkv, D, lens, n)
    q, jq = _pair(rng.standard_normal((B, 1, H, D)).astype(np.float32), dtype)
    k, jk = _pair(kp, dtype)
    v, jv = _pair(vp, dtype)
    lengths = np.asarray(lens, np.int32)
    bt, tl = torch.from_numpy(table), torch.from_numpy(lengths)
    got = pa.paged_decode(q, k, v, bt, tl, softcap=softcap)
    assert got.dtype == q.dtype and got.shape == (B, 1, H, D)
    want_p = jax_pa.paged_flash_decode(jq, jk, jv, jnp.asarray(table), jnp.asarray(lengths),
                                       softcap=softcap, interpret=True)
    want_x = jax_ops.paged_decode_attention(jq, jk, jv, jnp.asarray(table), jnp.asarray(lengths),
                                            softcap=softcap, impl="xla")
    _check_attention(got, want_p, want_x, dtype, case)
    assert (got[torch.from_numpy(lengths == 0)] == 0).all()     # idle slots give exactly 0
    for impl in ("auto", "torch"):
        assert torch.equal(ops.paged_decode_attention(q, k, v, bt, tl, softcap=softcap,
                                                      impl=impl), got)


def test_paged_decode_reads_only_the_live_pages_of_its_row():
    """Pages past a row's length, unmapped pages and the other rows' pages
    do not move its output."""
    rng = np.random.default_rng(2)
    kp, vp, table = _pool_and_table(rng, 2, 12, 8, 2, 64, [20, 35], 5)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 64)).astype(np.float32))
    k, v, bt = torch.from_numpy(kp), torch.from_numpy(vp), torch.from_numpy(table)
    lengths = torch.tensor([20, 35], dtype=torch.int32)
    base = ops.paged_decode_attention(q, k, v, bt, lengths)
    k2, v2 = k.clone(), v.clone()
    k2[table[0, 2], 4:], v2[table[0, 2], 4:] = 1e3, -1e3        # row 0's last page, past 20
    for p in set(range(12)) - set(table[0, :3].tolist()):
        k2[p], v2[p] = 5.0, -5.0
    assert torch.equal(ops.paged_decode_attention(q, k2, v2, bt, lengths)[0], base[0])


# ------------------------------------------------------------------ prefill
# (S, H, Hkv, D, page, n_tables, starts, valid, softcap): a chunk at start
# 0, chunks after a cached prefix or an earlier chunk (start > 0, not page
# aligned), bucket padding (valid < S), a row with no valid query
PREFILL_CASES = {
    "page8_group1_start0": (12, 2, 2, 64, 8, 4, [0, 0], [12, 7], 0.0),
    "page16_group7_start_gt0": (16, 7, 1, 128, 16, 4, [16, 21], [16, 9], 0.0),
    "page16_group7_softcap": (10, 14, 2, 64, 16, 3, [5, 30], [10, 3], 20.0),
    "page8_group2_padding": (16, 4, 2, 64, 8, 6, [24, 3], [5, 13], 20.0),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(PREFILL_CASES))
def test_paged_prefill_matches_pallas_and_xla(case, dtype):
    S, H, Hkv, D, page, n, starts, valid, softcap = PREFILL_CASES[case]
    B = len(starts)
    rng = np.random.default_rng(3)
    lens = [s + c for s, c in zip(starts, valid)]
    kp, vp, table = _pool_and_table(rng, B, 2 + B * n, page, Hkv, D, lens, n)
    q, jq = _pair(rng.standard_normal((B, S, H, D)).astype(np.float32), dtype)
    k, jk = _pair(kp, dtype)
    v, jv = _pair(vp, dtype)
    st, ln = np.asarray(starts, np.int32), np.asarray(lens, np.int32)
    args = (torch.from_numpy(table), torch.from_numpy(st), torch.from_numpy(ln))
    got = pa.paged_prefill(q, k, v, *args, softcap=softcap)
    assert got.dtype == q.dtype and got.shape == (B, S, H, D)
    jargs = (jnp.asarray(table), jnp.asarray(st), jnp.asarray(ln))
    want_p = jax_pa.paged_flash_prefill(jq, jk, jv, *jargs, softcap=softcap, interpret=True)
    want_x = jax_ops.paged_prefill_attention(jq, jk, jv, *jargs, softcap=softcap, impl="xla")
    _check_attention(got, want_p, want_x, dtype, case)
    for impl in ("auto", "torch"):
        assert torch.equal(ops.paged_prefill_attention(q, k, v, *args, softcap=softcap,
                                                       impl=impl), got)


def test_paged_prefill_fully_masked_rows_give_zeros_and_match_one_shot_attention():
    """A chunk at start 0 with every row valid is causal attention over the
    chunk; a query row that sees no key (length 0) gives zeros."""
    rng = np.random.default_rng(4)
    S, H, Hkv, D, page = 20, 4, 2, 64, 8
    kp, vp, table = _pool_and_table(rng, 2, 8, page, Hkv, D, [S, 0], 3)
    q = torch.from_numpy(rng.standard_normal((2, S, H, D)).astype(np.float32))
    k, v, bt = torch.from_numpy(kp), torch.from_numpy(vp), torch.from_numpy(table)
    got = ops.paged_prefill_attention(q, k, v, bt, torch.tensor([0, 0], dtype=torch.int32),
                                      torch.tensor([S, 0], dtype=torch.int32))
    assert (got[1] == 0).all()
    dense_k = ref._gather_pages(k, bt[:1])[:, :S]
    dense_v = ref._gather_pages(v, bt[:1])[:, :S]
    want, _ = ref.attention_ref(q[:1], dense_k, dense_v, causal=True)
    np.testing.assert_allclose(got[:1].numpy(), want.numpy(), atol=1e-5, rtol=0)


def test_prefill_box_rows_follow_the_page():
    """A TMA box lies in one page and is a whole number of 8-row swizzle
    atoms; any other page is gathered row by row."""
    want = {8: 8, 16: 16, 24: 8, 32: 32, 48: 16, 64: 64, 128: 64, 256: 64, 1: 0, 12: 0, 20: 0}
    assert {page: pa.box_rows(page) for page in want} == want


@pytest.mark.parametrize("page", [8, 16, 12])
@pytest.mark.parametrize("case", list(PREFILL_CASES))
def test_paged_prefill_tiles_cover_exactly_the_admitted_keys(case, page):
    """The prefill kernel's addressing, mirrored on the host: for every
    (row, query tile) of each case, the key tiles it streams and the boxes
    (or single rows) that fill them read every key the plain version's mask
    admits for some row of the tile from that key's own pool row, read no
    key past the length rounded up to a box, stream no tile past the last
    admitted key, and aim a copy past the pool (zeros) only at or past the
    length."""
    S, _, _, D, _, _, starts, valid, _ = PREFILL_CASES[case]
    lens = [s + c for s, c in zip(starts, valid)]
    n_tables = -(-max(lens) // page) + 1
    num_pages = 2 + len(starts) * n_tables
    _, _, table = _pool_and_table(np.random.default_rng(5), len(starts), num_pages, page, 1, 8,
                                  lens, n_tables)
    keys, rows = FWD_KEYS[D], pa.box_rows(page) or 1
    pool_rows = num_pages * page
    for b, (start, length) in enumerate(zip(starts, lens)):
        for q0 in range(0, S, TILE):
            last = start + min(q0 + TILE, S) - 1   # the tile's last query position
            admitted = [k for k in range(length) if k <= last]
            tiles = pa.prefill_key_tiles(q0, S, start, length, keys)
            read = {}
            for k0 in tiles:
                for r0, src, n in pa.tile_sources(table[b], k0, keys, page, length, pool_rows):
                    assert n == rows
                    if src == pool_rows:
                        assert k0 + r0 >= length
                        continue
                    for i in range(n):
                        read[k0 + r0 + i] = src + i
            for k in admitted:
                assert read.get(k) == table[b, k // page] * page + k % page, (b, q0, k)
            assert all(k < -(-length // rows) * rows for k in read)
            if admitted:
                assert tiles[-1] <= admitted[-1] < tiles[-1] + keys
            else:
                assert len(tiles) == 0


# ------------------------------------------------------------------ the K/V writes
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("page", [8, 16])
def test_paged_kv_write_matches_pallas_with_idle_slots_on_the_null_page(page, dtype):
    rng = np.random.default_rng(5)
    P, Hkv, D, B = 9, 2, 64, 6
    kp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    kn = rng.standard_normal((B, 1, Hkv, D)).astype(np.float32)
    vn = rng.standard_normal((B, 1, Hkv, D)).astype(np.float32)
    # slots 1, 3 and 4 are idle: all on row 0 of the null page 0
    page_idx = np.array([5, 0, 2, 0, 0, 7], np.int32)
    row = np.array([page - 1, 0, 3, 0, 0, 0], np.int32)
    k, jk = _pair(kp, dtype)
    v, jv = _pair(vp, dtype)
    knt, jkn = _pair(kn, dtype)
    vnt, jvn = _pair(vn, dtype)
    wk, wv = jax_pa.paged_kv_write(jk, jv, jkn, jvn, jnp.asarray(page_idx), jnp.asarray(row),
                                   interpret=True)
    for impl in ("auto", "torch"):
        gk, gv = k.clone(), v.clone()
        out = ops.paged_kv_update(gk, gv, knt, vnt, torch.from_numpy(page_idx),
                                  torch.from_numpy(row), impl=impl)
        assert out[0] is gk and out[1] is gv                     # in place
        # a copy: exact, on every page but the null page
        np.testing.assert_array_equal(gk[1:].float().numpy(), _np(wk)[1:])
        np.testing.assert_array_equal(gv[1:].float().numpy(), _np(wv)[1:])
        # the null page's row 0 holds one of the colliding idle slots' rows
        assert any(torch.equal(gk[0, 0], knt[b, 0]) for b in (1, 3, 4))
        assert torch.equal(gk[0, 1:], k[0, 1:])
    assert pa.paged_kv_write.launches == 0


# the decode step's insert fused into the decode: (B, H, Hkv, D, page,
# n_tables, slots, softcap); a slot is ("live", pos) on pages of its own,
# ("idle", 0) with its table row on the null page, or ("masked", pos), a
# mid-prefill slot whose table row is masked to the null page
APPEND_CASES = {
    "page8_D64_group1": (5, 2, 2, 64, 8, 6, [("live", 40), ("idle", 0), ("live", 0),
                                            ("masked", 13), ("live", 7)], 0.0),
    "page12_D128_group7": (4, 7, 1, 128, 12, 4, [("live", 35), ("live", 12), ("idle", 0),
                                                ("live", 47)], 0.0),
    "page16_D128_group7_softcap": (4, 14, 2, 128, 16, 4, [("live", 16), ("masked", 30),
                                                         ("live", 63), ("idle", 0)], 20.0),
    "page16_D64_length1": (3, 4, 2, 64, 16, 3, [("live", 0), ("live", 0), ("live", 33)], 0.0),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(APPEND_CASES))
def test_paged_decode_append_matches_pallas_update_then_decode(case, dtype, monkeypatch):
    """The fused op's plain version against the reference's decode-step
    pair, ``ops.paged_kv_update`` then ``ops.paged_decode_attention``, in
    Pallas interpret mode and on its XLA path, with the addresses of
    ``paged_decode_addressing``: the live rows' output at the file's
    tolerances and the pools outside the null page equal; idle and masked
    slots (on the null page, where their writes collide) finite."""
    B, H, Hkv, D, page, n, slots, softcap = APPEND_CASES[case]
    rng = np.random.default_rng(7)
    pos = np.array([p for _, p in slots], np.int32)
    live = np.array([kind == "live" for kind, _ in slots])
    kp, vp, table = _pool_and_table(rng, B, 2 + B * n, page, Hkv, D,
                                    np.where(live, pos + 1, 0), n)
    q, jq = _pair(rng.standard_normal((B, 1, H, D)).astype(np.float32), dtype)
    kn, jkn = _pair(rng.standard_normal((B, 1, Hkv, D)).astype(np.float32), dtype)
    vn, jvn = _pair(rng.standard_normal((B, 1, Hkv, D)).astype(np.float32), dtype)
    k, jk = _pair(kp, dtype)
    v, jv = _pair(vp, dtype)
    bt = torch.from_numpy(table)
    addr = paged_decode_addressing(bt, torch.from_numpy(pos), page)
    a = {name: t.numpy() for name, t in addr.items()}
    assert (a["lengths"] == pos + 1).all() and (a["page_idx"][~live] == 0).all()
    jargs = [jnp.asarray(a[name]) for name in ("page_idx", "row")]

    def reference(impl):
        wk, wv = jax_ops.paged_kv_update(jk, jv, jkn, jvn, *jargs, impl=impl)
        out = jax_ops.paged_decode_attention(jq, wk, wv, jnp.asarray(table),
                                             jnp.asarray(a["lengths"]), softcap=softcap,
                                             impl=impl)
        return out, wk, wv

    want_x, _, _ = reference("xla")
    monkeypatch.setenv("REPRO_FORCE_IMPL", "pallas_interpret")
    want_p, wk, wv = reference("auto")
    outs = []
    for impl in ("auto", "torch"):
        gk, gv = k.clone(), v.clone()
        got = ops.paged_decode_append(q, gk, gv, kn, vn, bt, addr["lengths"], addr["page_idx"],
                                      addr["row"], softcap=softcap, impl=impl)
        assert got.dtype == q.dtype and got.shape == (B, 1, H, D)
        idx = torch.from_numpy(live)
        _check_attention(got[idx], _np(want_p)[live], _np(want_x)[live], dtype, case)
        assert bool(got.isfinite().all())
        np.testing.assert_array_equal(gk[1:].float().numpy(), _np(wk)[1:])
        np.testing.assert_array_equal(gv[1:].float().numpy(), _np(wv)[1:])
        outs.append((got, gk, gv))
    assert all(torch.equal(x, y) for x, y in zip(*outs))
    assert pa.paged_decode.launches == pa.paged_decode.appends == 0


@pytest.mark.parametrize("capacity", [16, 256, 272, 1000, 2048])
def test_append_has_one_writer_per_slot_and_kv_head(capacity):
    """The fused insert's writer, mirrored from the kernel: for every
    length, exactly one stage of one block of a (slot, kv head) stores the
    new row, in split (length - 1) // 256, a split the kernel runs (below
    its split count, before the length: the early return skips only splits
    past the length), in the stage that holds position length - 1; a
    length past the capacity writes at capacity - 1, and length 0 nowhere."""
    splits = -(-capacity // 256)
    assert pa.append_sites(0, capacity) == []
    for length in list(range(1, capacity + 1)) + [capacity + 5]:
        at = min(length, capacity) - 1
        sites = pa.append_sites(length, capacity)
        assert len(sites) == 1, (length, sites)
        split, key0 = sites[0]
        k0 = split * 256
        assert split == at // 256 < splits and k0 <= at
        assert k0 + key0 <= at < k0 + key0 + 16 and key0 % 16 == 0


@pytest.mark.parametrize("page", [8, 16])
def test_paged_kv_update_rows_matches_reference_scatter(page):
    rng = np.random.default_rng(6)
    P, Hkv, D, S = 6, 2, 64, 11
    kp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    kn = rng.standard_normal((S, Hkv, D)).astype(np.float32)
    vn = rng.standard_normal((S, Hkv, D)).astype(np.float32)
    start = page - 3                                   # a chunk crossing a page boundary
    pos = start + np.arange(S)
    table = np.array([3, 1, 4, 0], np.int32)
    page_idx = np.where(np.arange(S) < 8, table[pos // page], 0).astype(np.int32)   # 3 padded rows
    wk, wv = jax_ops.paged_kv_update_rows(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(kn),
                                          jnp.asarray(vn), jnp.asarray(page_idx),
                                          jnp.asarray(pos % page))
    gk, gv = ops.paged_kv_update_rows(torch.from_numpy(kp), torch.from_numpy(vp),
                                      torch.from_numpy(kn), torch.from_numpy(vn),
                                      torch.from_numpy(page_idx), torch.from_numpy(pos % page))
    np.testing.assert_array_equal(gk[1:].numpy(), np.asarray(wk)[1:])
    np.testing.assert_array_equal(gv[1:].numpy(), np.asarray(wv)[1:])


# ------------------------------------------------------------------ wrappers
def test_paged_wrapper_argument_checks():
    bf = torch.bfloat16
    q = torch.zeros(2, 1, 8, 64, dtype=bf)
    pool = torch.zeros(5, 16, 2, 64, dtype=bf)
    bt = torch.zeros(2, 3, dtype=torch.int32)
    ln = torch.zeros(2, dtype=torch.int32)
    pa.check_decode_args(q, pool, pool, bt, ln)
    for page in (1, 8, 12, 16, 32, 64):     # a stage through one page, or row by row
        pages = torch.zeros(5, page, 2, 64, dtype=bf)
        pa.check_decode_args(q, pages, pages, bt, ln)
    bad_decode = [
        ((q[:, :, :5], pool, pool, bt, ln), ValueError),                     # H % Hkv
        ((q.float(), pool.float(), pool.float(), bt, ln), TypeError),
        ((q, pool, pool, bt.long(), ln), ValueError),                        # table dtype
        ((q, pool, pool, bt[:1], ln), ValueError),                           # table rows
        ((q, pool, pool, bt, ln[:1]), ValueError),
        ((q, pool.transpose(1, 2), pool.transpose(1, 2), bt, ln), ValueError),  # pool layout
        ((torch.zeros(2, 1, 34, 64, dtype=bf), pool, pool, bt, ln), ValueError),  # group 17
        ((torch.zeros(2, 1, 8, 96, dtype=bf), torch.zeros(5, 16, 2, 96, dtype=bf),
          torch.zeros(5, 16, 2, 96, dtype=bf), bt, ln), ValueError),        # D 96
    ]
    for args, err in bad_decode:
        with pytest.raises(err):
            pa.check_decode_args(*args)
    qs = torch.zeros(2, 10, 8, 64, dtype=bf)
    pa.check_prefill_args(qs, pool, pool, bt, ln, ln)
    for args, err in [((qs, pool, pool, bt, ln.long(), ln), ValueError),
                      ((qs[..., :32], pool, pool, bt, ln, ln), ValueError),
                      ((qs.half(), pool, pool, bt, ln, ln), TypeError)]:
        with pytest.raises(err):
            pa.check_prefill_args(*args)
    kn = torch.zeros(2, 1, 2, 64, dtype=bf)
    pa.check_write_args(pool, pool, kn, kn, ln, ln)
    for args, err in [((pool, pool, kn[:, :, :1], kn, ln, ln), ValueError),
                      ((pool, pool, kn.float(), kn, ln, ln), TypeError),
                      ((pool, pool, kn, kn, ln[:1], ln), ValueError),
                      ((pool.float(), pool.float(), kn, kn, ln, ln), TypeError)]:
        with pytest.raises(err):
            pa.check_write_args(*args)
    meta = q.to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_decode(meta, pool, pool, bt, ln)
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_prefill(qs.to("meta"), pool, pool, bt, ln, ln)
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_kv_write(pool.to("meta"), pool, kn, kn, ln, ln)
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_decode(meta, pool, pool, bt, ln, k_new=kn, v_new=kn, page_idx=ln, row=ln)
    with pytest.raises(ValueError, match="all of"):
        pa.paged_decode(q, pool, pool, bt, ln, k_new=kn, v_new=kn)


def test_cpu_dispatch_launches_no_paged_kernel():
    pool = torch.zeros(4, 8, 1, 64)
    bt = torch.tensor([[1, 2]], dtype=torch.int32)
    one = torch.tensor([3], dtype=torch.int32)
    ops.paged_decode_attention(torch.zeros(1, 1, 2, 64), pool, pool, bt, one)
    ops.paged_prefill_attention(torch.zeros(1, 4, 2, 64), pool, pool, bt,
                                torch.tensor([0], dtype=torch.int32), one)
    ops.paged_kv_update(pool, pool, torch.zeros(1, 1, 1, 64), torch.zeros(1, 1, 1, 64), one, one)
    ops.paged_decode_append(torch.zeros(1, 1, 2, 64), pool, pool, torch.zeros(1, 1, 1, 64),
                            torch.zeros(1, 1, 1, 64), bt, one, one, one)
    assert pa.paged_decode.launches == pa.paged_prefill.launches == pa.paged_kv_write.launches == 0
    assert pa.paged_decode.appends == 0
