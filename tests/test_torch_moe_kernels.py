"""The MoE's ragged grouped matmul on the CPU: the plain PyTorch version
against the reference's TPU kernel run in Pallas interpret mode and against
its gather oracle, on the same seeded numpy inputs, across group counts and
ragged edge cases; its gradients against ``jax.vjp`` of the reference's
custom VJP; the op's dispatch; the kernel wrappers' refusals; and the host
mirror of the kernels' schedules (the forward's in both modes, the
backward's) against the reference's."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.grouped_matmul import gmm as jax_gmm  # noqa: E402
from repro.kernels.grouped_matmul import gmm_metadata as jax_gmm_metadata  # noqa: E402
from repro.kernels.grouped_matmul import tgmm_metadata as jax_tgmm_metadata  # noqa: E402
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


# ---- the kernels' schedules (their host mirror in grouped_matmul.py)

def _router_draw(tokens, E, cap, seed):
    """Group sizes of a seeded skewed top-1 router draw, each cut to the
    capacity (as chip_smoke.py draws Scout's and Maverick's)."""
    rng = np.random.default_rng(seed)
    p = np.exp(1.5 * rng.standard_normal(E))
    return np.minimum(np.bincount(rng.choice(E, size=tokens, p=p / p.sum()), minlength=E),
                      cap).tolist()


# CASES, a Scout capacity-160 draw of a 2 x 1024 micro-batch over 16 experts
# (M 2048), and Maverick's 128 experts at capacity 16
SCHEDULE_CASES = CASES + [(16, 2048, _router_draw(2048, 16, 160, 3)),
                          (128, 1024, _router_draw(1024, 128, 16, 4))]


def _reference_rows(sizes, M, metadata=jax_tgmm_metadata):
    """Each group's rows as the reference's dW schedule (or, with
    ``gmm_metadata``, its forward's) masks them: an entry's m-tile rows
    within [lo, hi)."""
    bm = 16
    gid, mid, lo, hi, _ = (np.asarray(a) for a in metadata(
        jnp.asarray(sizes, jnp.int32), -(-M // bm), bm))
    rows = {g: set() for g in range(len(sizes))}
    for g, m, a, b in zip(gid, mid, lo, hi):
        rows[int(g)].update(range(max(int(a), int(m) * bm), min(int(b), int(m) * bm + bm, M)))
    return rows


@pytest.mark.parametrize("K,N", [(96, 80), (200, 136), (5120, 8192)])
@pytest.mark.parametrize("E,M,sizes", SCHEDULE_CASES, ids=lambda c: str(c)[:40])
def test_dw_schedule_owns_every_tile_once_and_sums_each_groups_rows(E, M, sizes, K, N):
    """Every (group, K tile, N tile) of dW is one of the kernel's tiles,
    once, an empty group's too (the kernel stores its zeros), group by
    group; a group's slices start at its first row and cover its rows
    exactly once, the rows the reference's dW schedule sums."""
    tiles = gm.dw_tiles(E, K, N)
    assert [g for g, *_ in tiles] == sorted(g for g, *_ in tiles)      # group-major
    tiles_k, tiles_n = -(-K // gm.DW_TILE_K), -(-N // gm.DW_TILE_N)
    assert len(tiles) == len(set(tiles)) == E * tiles_k * tiles_n
    assert set(tiles) == {(g, tk * gm.DW_TILE_K, tn * gm.DW_TILE_N) for g in range(E)
                          for tk in range(tiles_k) for tn in range(tiles_n)}
    starts = gm.group_starts(sizes, M)
    want = _reference_rows(sizes, M)
    for g in range(E):
        slices = gm.dw_slices(starts, g)
        rows = [m0 + r for m0, n in slices for r in range(n)]
        assert len(rows) == len(set(rows)) and set(rows) == want[g], g
        assert all(0 < n <= gm.SLICE for _, n in slices)
        assert all(n == gm.SLICE for _, n in slices[:-1])            # only the last is cut


@pytest.mark.parametrize("N", [136, 5120])
@pytest.mark.parametrize("E,M,sizes", SCHEDULE_CASES, ids=lambda c: str(c)[:40])
def test_dx_row_tiles_start_at_group_starts_and_partition_the_rows(E, M, sizes, N):
    """The transposed mode's tiles partition each group's rows (the
    reference's) from its start, none spanning two groups, for every column
    tile; rows [sum(sizes), M) are covered exactly once as the zero tail;
    the items fit the grid's static bound."""
    items = gm.dx_items(sizes, M, N)
    assert len(items) <= gm.dx_grid_bound(M, E, N)
    starts = gm.group_starts(sizes, M)
    want = _reference_rows(sizes, M)
    total = starts[E]
    for n0 in range(0, N, gm.DX_TILE_N):
        tiles = [(q, m0, hi) for q, m0, hi, c in items if c == n0]
        covered = [r for _, m0, hi in tiles for r in range(m0, hi)]
        assert sorted(covered) == list(range(M))                         # each row once
        for q, m0, hi in tiles:
            assert 0 < hi - m0 <= gm.DX_TILE_M
            if q < E:
                assert starts[q] <= m0 and hi <= starts[q + 1]           # within one group
                assert (m0 - starts[q]) % gm.DX_TILE_M == 0              # aligned to its start
            else:
                assert total <= m0 and hi <= M                           # the zero tail
        for g in range(E):
            assert {r for q, m0, hi in tiles if q == g for r in range(m0, hi)} == want[g]
    # a group's row tiles of one column tile run side by side
    for q in range(E):
        cols = [c for g, _, _, c in items if g == q]
        assert cols == sorted(cols)


@pytest.mark.parametrize("K,N", [(96, 80), (200, 136), (5120, 8192)])
@pytest.mark.parametrize("E,M,sizes", SCHEDULE_CASES, ids=lambda c: str(c)[:40])
def test_forward_items_cover_each_groups_rows_once_from_its_start(E, M, sizes, K, N):
    """The forward's items, in either mode (decode at 128 rows or fewer,
    row tiles above): for every column tile, each row the reference's
    forward schedule gives a group is computed by that group's items over
    the whole depth exactly once, the depth in 64-deep K splits taken in
    order, each split once; a group's tiles start at its first row; and the
    rows [sum(sizes), M) are written once, as zeros; the row-tile mode's
    items fit its static bound."""
    items = gm.fwd_items(sizes, M, K, N)
    starts = gm.group_starts(sizes, M)
    want = _reference_rows(sizes, M, jax_gmm_metadata)
    total, decode = starts[E], M <= gm.SPLIT_MAX_ROWS
    if not decode:   # the row-tile mode's static bound, as the transposed mode's
        assert len(items) <= gm.dx_grid_bound(M, E, N)
    tile_n = gm.SPLIT_TILE_N if decode else gm.DX_TILE_N
    n0s = sorted({n0 for _, _, _, n0, _, _ in items})
    assert n0s == list(range(0, N, tile_n)) or (total == M == 0)
    for n0 in n0s:
        col = [it for it in items if it[3] == n0]
        tail = [(m0, hi) for q, m0, hi, _, _, _ in col if q == E]
        assert sorted(r for m0, hi in tail for r in range(m0, hi)) == list(range(total, M))
        for g in range(E):
            mine = [(m0, hi, k0, k1) for q, m0, hi, _, k0, k1 in col if q == g]
            depths = {}
            for m0, hi, k0, k1 in mine:
                assert starts[g] <= m0 < hi <= starts[g + 1]
                tile = gm.SPLIT_MAX_ROWS if decode else gm.DX_TILE_M
                assert (m0 - starts[g]) % tile == 0                    # from the group's start
                assert 0 <= k0 < k1 <= K and k0 % gm.SLICE == 0
                for r in range(m0, hi):
                    depths.setdefault(r, []).append((k0, k1))
            assert set(depths) == want[g], g
            for r, ks in depths.items():                                # [0, K) once, in order
                assert [k0 for k0, _ in ks] == [0] + [k1 for _, k1 in ks[:-1]] and ks[-1][1] == K
            if decode and mine:
                assert {(m0, hi) for m0, hi, _, _ in mine} == {(starts[g], starts[g + 1])}
                n_split = len(mine)
                assert 1 <= n_split <= min(gm.MAX_SPLIT, -(-K // gm.SLICE))
                assert all(len(ks) == n_split for ks in depths.values())


@pytest.mark.parametrize("K,N", [(5120, 8192), (8192, 5120)])
def test_decode_split_fills_the_waves_of_the_sms(K, N):
    """At Scout's decode widths, for every number of live experts, the
    chosen K split keeps the busiest of the 132 SMs within 1 / 0.85 of an
    even share of the slices (with each item's fixed cost), where no split
    leaves it at up to 3.3 times that."""
    tiles_n, n_slices = -(-N // gm.SPLIT_TILE_N), -(-K // gm.SLICE)
    worst_unsplit = 1.0
    for live in range(1, 17):
        tiles = live * tiles_n
        S = gm.fwd_split(tiles, n_slices)
        even = tiles * n_slices / gm.SMS
        busiest = -(-tiles * S // gm.SMS) * (-(-n_slices // S) + gm.SPLIT_ITEM_COST)
        assert even / busiest >= 0.85, (live, S)
        worst_unsplit = min(worst_unsplit, even / (-(-tiles // gm.SMS) * (n_slices + 1)))
    assert worst_unsplit < 0.85


def test_forward_mode_follows_the_row_count():
    """128 rows or fewer take the decode mode (one split item a live group,
    column tile and K split, all the group's rows); more rows take row
    tiles of 256 from each group's start."""
    sizes = [60, 0, 68]
    decode = gm.fwd_items(sizes, 128, 256, 128)
    assert {(q, m0, hi) for q, m0, hi, *_ in decode} == {(0, 0, 60), (2, 60, 128)}
    rows = gm.fwd_items(sizes + [1], 129, 256, 128)
    assert [it[:3] for it in rows] == [(0, 0, 60), (2, 60, 128), (3, 128, 129)]
    assert all(it[4:] == (0, 256) for it in rows)


def _misaligned(*shape):
    """A contiguous bf16 tensor whose base lies 2 bytes past a 16-byte
    boundary."""
    n = int(np.prod(shape))
    t = torch.zeros(n + 1, dtype=torch.bfloat16)[1:].view(*shape)
    assert t.data_ptr() % 16 == 2
    return t


@pytest.mark.parametrize("entry", ["gmm", "gmm weights", "gmm transposed", "gmm_dw"])
@pytest.mark.parametrize("what", ["base", "row stride"])
def test_kernel_argument_checks_for_tma(entry, what):
    """What the tensor maps demand of every operand: a 16-byte aligned base
    and rows whose byte stride is a multiple of 16 (K and N multiples of 8
    in bf16) — the forward's x map, its (N, K, E) weight map, the
    transposed mode's and gmm_dw's."""
    z = lambda *s: torch.zeros(*s, dtype=torch.bfloat16)  # noqa: E731
    gs = torch.zeros(2, dtype=torch.int32)
    if what == "base":
        match = "16-byte aligned"
        args = {"gmm": (_misaligned(4, 16), z(2, 16, 8)),
                "gmm weights": (z(4, 16), _misaligned(2, 16, 8)),
                "gmm transposed": (z(4, 16), _misaligned(2, 8, 16)),
                "gmm_dw": (z(4, 16), _misaligned(4, 8))}[entry]
    else:
        match = "multiples of 8"
        args = {"gmm": (z(4, 12), z(2, 12, 8)),
                "gmm weights": (z(4, 16), z(2, 16, 12)),
                "gmm transposed": (z(4, 20), z(2, 8, 20)),
                "gmm_dw": (z(4, 16), z(4, 12))}[entry]
    with pytest.raises(ValueError, match=match):
        if entry == "gmm_dw":
            gm.check_dw_args(*args, gs)
        else:
            gm.check_args(*args, gs, transpose_w=entry == "gmm transposed")


def test_backward_kernel_route_calls_no_library_product():
    """The wrappers and the backward hand every product to the kernels: no
    matmul (``@``, ``matmul``, ``mm``, ``bmm``, ``einsum``, ``_grouped_mm``)
    in the module, each wrapper calls its plain version once, behind the CPU
    test, then the kernel or a raise; the autograd backward calls only the
    two wrappers; and the CUDA source includes no library header."""
    import ast
    import inspect

    banned = {"_grouped_mm", "matmul", "mm", "bmm", "baddbmm", "einsum"}
    tree = ast.parse(inspect.getsource(gm))
    for node in ast.walk(tree):
        assert not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult))
        assert not (isinstance(node, ast.Attribute) and node.attr in banned), node.attr
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    for name, plain, lib in (("gmm", "grouped_matmul_ref(", "_lib().grouped_matmul("),
                             ("gmm_dw", "grouped_matmul_dw_ref(", "_lib().grouped_matmul_dw(")):
        src = ast.unparse(fns[name])
        assert src.count(plain) == 1 and "if x.device.type == 'cpu':" in src, name
        assert src.index(plain) < src.index(lib) and "try:" not in src, name
    cls = next(n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == "_GroupedMatmul")
    bwd = next(n for n in cls.body if isinstance(n, ast.FunctionDef) and n.name == "backward")
    called = {n.func.id for n in ast.walk(bwd) if isinstance(n, ast.Call)
              and isinstance(n.func, ast.Name)}
    assert called == {"gmm", "gmm_dw"}
    cu = (gm._build.CSRC / "grouped_matmul.cu").read_text()
    includes = {ln.split()[1] for ln in cu.splitlines() if ln.startswith("#include")}
    assert includes == {"<cuda.h>", "<cuda_runtime.h>", "<stdint.h>", '"hopper.cuh"', '"mma.cuh"'}
