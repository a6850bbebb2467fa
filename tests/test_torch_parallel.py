"""The port's mesh layout without a process group: ``axis_rules``, ``spec``
and ``fit_spec`` against the reference's on the same mesh sizes,
``ParallelConfig`` and its ``validate``, each rank's block of a leaf (the
blocks of every rank tile the leaf, uneven dims replicated), the leaf
rules of head-TP and context parallelism, ``build_model`` on one rank of a
mesh (``MeshCoords``) whose shards put together are the mesh-free model,
the batch rows a rank keeps, the train-state placement helpers, the
input shapes, and the meshes the launcher and ``launch/mesh.py`` refuse.
The collectives run in ``tests/test_torch_distributed.py``."""
import dataclasses
import itertools
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.config import ModelConfig as JaxModelConfig  # noqa: E402
from repro.core.config import ParallelConfig as JaxParallelConfig  # noqa: E402
from repro.launch import shapes as jax_shapes  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.parallel import sharding as jax_sharding  # noqa: E402
from repro.training import train_step as jax_ts  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.config import ModelConfig, ParallelConfig  # noqa: E402
from repro_torch.core.module import tree_leaves, tree_map  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.launch import shapes  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.model import Model, build_model, param_defs  # noqa: E402
from repro_torch.parallel import sharding as S  # noqa: E402
from repro_torch.training import train_step as TS  # noqa: E402

MESHES = [((2, 4), ("data", "model")), ((4, 2), ("data", "model")), ((1, 4), ("data", "model")),
          ((16, 16), ("data", "model")), ((2, 1, 2), ("pod", "data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
PCS = [dict(), dict(attention_parallelism="context"), dict(fsdp_axes=("pod", "data")),
       dict(attention_parallelism="context", fsdp_axes=())]


def _ids(v):
    return "x".join(map(str, v)) if isinstance(v[0], int) else "-".join(v)


def _jax_mesh(shape, axes):
    """What the reference's rules read of a mesh: its axis names and the
    devices array's shape."""
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape, dtype=object))


def _norm(pspec):
    """A spec with its one-axis tuples as bare names (the reference's
    ``PartitionSpec`` writes them so)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in pspec)


def _coords(shape, axes):
    return [S.MeshCoords(axes, shape, c) for c in itertools.product(*map(range, shape))]


def _dense(**kw):
    base = dict(name="t", family="dense", num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
                d_ff=128, vocab_size=128, dtype="float32")
    base.update(kw)
    return JaxModelConfig(**base), ModelConfig(**base)


@pytest.mark.parametrize("pc_kw", PCS, ids=lambda d: "-".join(f"{k}={v}" for k, v in d.items())
                         or "default")
@pytest.mark.parametrize("shape,axes", MESHES, ids=_ids)
def test_rules_spec_and_fit_spec_match_the_reference(shape, axes, pc_kw):
    jm, sizes = _jax_mesh(shape, axes), dict(zip(axes, shape))
    jpc, pc = JaxParallelConfig(**pc_kw), ParallelConfig(**pc_kw)
    rules, jrules = S.axis_rules(pc, sizes), jax_sharding.axis_rules(jpc, jm)
    assert rules == jrules
    assert S.mesh_axis_sizes(S.MeshCoords(axes, shape, (0,) * len(shape))) == sizes
    _, cfg = _dense()
    for name in ("esm2-650m", "qwen2-7b", "llama4-scout-17b-a16e", "mamba2-2.7b"):
        for p in tree_leaves(param_defs(get_smoke_config(name))) + tree_leaves(param_defs(cfg)):
            got, want = S.spec(rules, *p.axes), jax_sharding.spec(jrules, *p.axes)
            assert _norm(got) == _norm(want)
            assert _norm(S.fit_spec(p.shape, sizes, got)) == _norm(
                jax_sharding.fit_spec(p.shape, jm, want))
    for logical in (("batch", "seq"), ("batch", "seq_cp", "embed"), ("tokens",),
                    ("cache_batch", "cache_seq", "kv_tp", None), ("layers", "experts", "fsdp")):
        assert _norm(S.spec(rules, *logical)) == _norm(jax_sharding.spec(jrules, *logical))
    assert S.null_ctx().mesh is None and S.null_ctx().sp("batch") == ()


def test_parallel_config_fields_and_validate_match_the_reference():
    # the fields the port reads, each with the reference's name and default
    ref = {f.name: f.default for f in dataclasses.fields(JaxParallelConfig)}
    got = {f.name: f.default for f in dataclasses.fields(ParallelConfig)}
    assert set(got) == {"attention_parallelism", "fsdp_axes", "remat_policy",
                        "optimizer_state_dtype"}
    assert got == {k: ref[k] for k in got}
    for heads, tp, mode in itertools.product((6, 8, 20), (1, 2, 4, 16), ("head_tp", "context")):
        jcfg, cfg = _dense(num_heads=heads, num_kv_heads=2, d_model=8 * heads)
        got = ParallelConfig(attention_parallelism=mode).validate(cfg, tp)
        want = JaxParallelConfig(attention_parallelism=mode).validate(jcfg, tp)
        assert got.attention_parallelism == want.attention_parallelism
    pc = ParallelConfig()
    assert pc.validate(_dense()[1], 4) is pc
    with pytest.raises(ValueError, match="attention_parallelism"):
        ParallelConfig(attention_parallelism="sequence")
    with pytest.raises(ValueError, match="fsdp_axes"):
        ParallelConfig(fsdp_axes=("model",))


@pytest.mark.parametrize("shape,axes", MESHES[:3] + MESHES[4:5], ids=_ids)
def test_every_rank_block_tiles_the_leaf_uneven_dims_replicated(shape, axes):
    sizes = dict(zip(axes, shape))
    rules = S.axis_rules(ParallelConfig(), sizes)
    g = torch.Generator().manual_seed(0)
    for dims, logical in (((12, 7), ("fsdp", "tp")), ((3, 8, 10), ("layers", "fsdp", "tp")),
                          ((8, 6), ("tp", "fsdp")), ((5,), ("tp",)), ((16,), (None,)),
                          ((4, 12, 16), ("experts", "fsdp", None))):
        x = torch.randn(dims, generator=g)
        st = S.fit_spec(dims, sizes, S.spec(rules, *logical))
        cover = torch.zeros(dims)
        out = torch.zeros(dims)
        for mc in _coords(shape, axes):
            ctx = S.ShardingCtx(mc, ParallelConfig())
            block = ctx.shard(x, st)
            assert tuple(block.shape) == S.shard_shape(dims, st, sizes)
            sl = S.shard_slices(dims, st, sizes, ctx.coords)
            out[sl] = block
            cover[sl] += 1
        assert torch.equal(out, x)
        # each element sits on as many ranks as the axes it is not sharded over
        rep = np.prod([n for a, n in sizes.items() if a not in S.spec_axes(st)])
        assert bool((cover == rep).all()), (dims, logical, st)
        for d, (dim, e) in enumerate(zip(dims, st + (None,) * len(dims))):
            n = int(np.prod([sizes[a] for a in S._axes(e)]))
            assert dim % n == 0


def test_head_tp_and_context_leaf_rules():
    mc = S.MeshCoords(("data", "model"), (2, 2), (1, 0))
    _, cfg = _dense()                      # 8 heads, 2 kv heads: kv divides over 2
    tp = S.ShardingCtx(mc, ParallelConfig())
    specs = tp.param_specs(param_defs(cfg), cfg)
    att, ffn = specs["layers"]["sub0"]["attn"], specs["layers"]["sub0"]["ffn"]
    assert att["wq"] == S.LeafSpec((None, "data", "model"), (None, None, "model"), ("data",))
    assert att["wk"].compute == (None, None, "model") and att["wo"].compute == (None, "model")
    assert ffn["w_in"].compute == (None, None, "model") and ffn["w_out"].compute == (None, "model")
    assert specs["embed"]["tok"] == S.LeafSpec(("model", "data"), (), ("data",))
    assert specs["layers"]["sub0"]["norm1"]["scale"] == S.LeafSpec((), (), ("data",))
    # four model ranks: the two kv heads are whole on every rank, their
    # gradient summed over model as well
    kv = S.ShardingCtx(S.MeshCoords(("data", "model"), (1, 4), (0, 3)), ParallelConfig())
    wk = kv.param_specs(param_defs(cfg), cfg)["layers"]["sub0"]["attn"]["wk"]
    assert wk.compute == () and wk.reduce == ("data", "model")
    cp = S.ShardingCtx(mc, ParallelConfig(attention_parallelism="context"))
    for ls in tree_leaves(cp.param_specs(param_defs(cfg), cfg)):
        assert ls.compute == () and ls.reduce == ("data", "model")
    assert cp.seq_chunk(32) == (0, 16) and S.ShardingCtx(
        S.MeshCoords(("data", "model"), (2, 2), (0, 1)), cp.pc).seq_chunk(32) == (16, 16)
    with pytest.raises(ValueError, match="do not divide"):
        cp.seq_chunk(31)
    # a sum over distinct elements: the sharded leaves count everywhere, a
    # replicated one only at coordinate 0 of the axes it is replicated over
    assert tp.owns(att["wq"].store) and tp.owns(specs["embed"]["tok"].store)
    assert not tp.owns(()) and S.ShardingCtx(mc._replace(coords=(0, 0)), tp.pc).owns(())
    assert tp.reduce_axes == ("data",) and cp.reduce_axes == ("data", "model")


@pytest.mark.parametrize("name,shape,pc_kw", [
    ("esm2-650m", (2, 2), {}), ("esm2-650m", (1, 4), {}), ("qwen2-7b", (2, 2), {}),
    ("qwen2-7b", (4, 1), {"attention_parallelism": "context"}),
    ("llama4-scout-17b-a16e", (4, 1), {}), ("mamba2-2.7b", (4, 1), {}),
])
def test_build_model_shards_put_together_are_the_mesh_free_model(name, shape, pc_kw):
    cfg = get_smoke_config(name)
    whole = build_model(cfg, device="cpu", seed=3).params.tree()
    axes = ("data", "model")
    sizes = dict(zip(axes, shape))
    out = tree_map(torch.zeros_like, whole)
    for mc in _coords(shape, axes):
        m = build_model(cfg, ParallelConfig(**pc_kw), mc, device="cpu", seed=3)
        # the whole tree through Model(...) shards the same way
        again = Model(cfg, whole, ParallelConfig(**pc_kw), mc).params.tree()
        for path_leaf in zip(_paths(whole), tree_leaves(m.params.tree()), tree_leaves(again)):
            path, shard, shard2 = path_leaf
            assert torch.equal(shard, shard2)
            st = m.spec_at(path).store
            sl = S.shard_slices(_at(whole, path).shape, st, sizes, m.ctx.coords)
            _at(out, path)[sl] = shard
    for a, b in zip(tree_leaves(out), tree_leaves(whole)):
        assert torch.equal(a, b)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], prefix + (k,))]
    return [prefix]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_the_model_axis_refuses_the_families_it_does_not_split():
    mc = S.MeshCoords(("data", "model"), (2, 2), (0, 0))
    for name in ("llama4-scout-17b-a16e", "mamba2-2.7b", "jamba-1.5-large-398b", "molmim-65m",
                 "internvl2-26b"):
        with pytest.raises(NotImplementedError, match="14b"):
            build_model(get_smoke_config(name), mesh=mc, device="cpu")
    m = build_model(get_smoke_config("esm2-650m"), mesh=mc, device="cpu")
    # a dense model serves: its caches hold the rank's K/V heads (2 of 4)
    cache = m.init_cache(2, 16, layout="paged", page_size=8, num_pages=5)
    assert cache["layers"]["sub0"]["attn"]["k_pool"].shape[-2] == 2
    assert cache["block_table"].shape == (2, 2)
    # six heads over four model ranks: validate's switch to context, whose
    # generation is not ported
    m = build_model(_dense(num_heads=6, d_model=48)[1], mesh=S.MeshCoords(("data", "model"), (1, 4),
                                                                           (0, 0)), device="cpu")
    assert m.pc.attention_parallelism == "context" and m.ctx.seq_parallel
    with pytest.raises(NotImplementedError, match="14e"):
        m.init_cache(2, 16)


@pytest.mark.parametrize("heads,kv,tp", [(28, 4, 2), (28, 4, 4), (128, 8, 8), (12, 3, 2),
                                         (8, 2, 4), (8, 8, 4), (6, 3, 2)])
def test_rank_kv_heads_are_the_heads_attention_picks(heads, kv, tp):
    """The K/V heads a rank caches (``rank_kv_heads``) are the ones its
    attention computes with (``_tp_kv``), and a GQA group of each rank's
    query heads over them stays within the decode kernels' 16."""
    from repro_torch.models.attention import _tp_kv

    cfg = ModelConfig(name="t", family="dense", num_layers=1, d_model=heads * 8, num_heads=heads,
                      num_kv_heads=kv, head_dim=8, d_ff=64, vocab_size=64)
    seen = set()
    for mc in _coords((1, tp), ("data", "model")):
        ctx = S.ShardingCtx(mc, ParallelConfig())
        idx = S.rank_kv_heads(cfg, ctx)
        # the projection: every K/V head whole where they do not divide
        width = kv // tp if kv % tp == 0 else kv
        first = idx[0] if kv % tp == 0 else 0
        k = (first + torch.arange(width, dtype=torch.float32))[None, None, :, None].expand(1, 2, -1, 8)
        got, _ = _tp_kv(cfg, ctx, k, k)
        assert got[0, 0, :, 0].long().tolist() == idx
        q_heads = heads // tp
        assert q_heads % len(idx) == 0 and q_heads // len(idx) <= 16
        seen.update(idx)
    assert seen == set(range(kv))


def test_batch_rows_keep_each_micro_batch_block():
    x = np.arange(16 * 3).reshape(16, 3)
    got = {}
    for mc in _coords((2, 2), ("data", "model")):
        got[mc.coords] = S.ShardingCtx(mc, ParallelConfig()).batch_rows(x, accum=2)
    # micro-batch i of the global batch is rows 8i..8i+7: data rank r keeps
    # rows 8i+4r..8i+4r+3 of it, the model ranks the same rows
    assert np.array_equal(got[(0, 0)], np.concatenate([x[0:4], x[8:12]]))
    assert np.array_equal(got[(1, 1)], np.concatenate([x[4:8], x[12:16]]))
    assert np.array_equal(got[(1, 0)], got[(1, 1)])
    with pytest.raises(ValueError, match="does not split"):
        S.ShardingCtx(_coords((2, 2), ("data", "model"))[0], ParallelConfig()).batch_rows(
            x[:6], accum=2)
    assert S.null_ctx().data_ranks == 1 and S.null_ctx().batch_rows(x) is x


def test_train_state_placement_matches_the_reference_specs():
    jcfg, cfg = _dense()
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    jmodel = jax_build_model(jcfg, JaxParallelConfig(), jmesh)
    want = jax_ts.train_state_specs(jmodel)
    mc = S.MeshCoords(("data", "model"), (2, 2), (1, 1))
    model = build_model(cfg, ParallelConfig(), mc, device="cpu")
    got = TS.train_state_specs(model)
    assert [_norm(s) for s in jax.tree.leaves(want.params, is_leaf=lambda s: isinstance(
        s, jax.sharding.PartitionSpec))] == [_norm(s) for s in tree_leaves(got.params)]
    assert got.opt.step == () and got.opt.mu is got.params
    abstract = TS.abstract_train_state(model)
    jabs = jax_ts.abstract_train_state(jmodel)
    assert [tuple(t.shape) for t in tree_leaves(abstract.params)] == \
        [tuple(s.shape) for s in jax.tree.leaves(jabs.params)]
    assert all(t.device.type == "meta" for t in tree_leaves(abstract.opt.mu))
    placed = TS.state_shardings(model)
    for pl, p, ls in zip(tree_leaves(placed.params), tree_leaves(model.params.tree()),
                         tree_leaves(model.specs)):
        assert pl.spec == ls.store
        assert tuple(s.stop - s.start for s in pl.index) == tuple(p.shape)
    assert TS.host_batch_sharding(model) == (("data",),)
    assert TS.host_batch_sharding(build_model(cfg, device="cpu")) == ()


def test_input_shapes_match_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jax_shapes.SHAPES.items()}
    rules = S.axis_rules(ParallelConfig(), {"pod": 2, "data": 16, "model": 16})
    jmesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"))
    jrules = jax_sharding.axis_rules(JaxParallelConfig(), jmesh)
    for name in ("esm2-650m", "qwen2-7b", "molmim-65m", "whisper-medium", "internvl2-26b"):
        cfg = get_smoke_config(name)
        jcfg = JaxModelConfig(**dataclasses.asdict(cfg))
        for shape in shapes.SHAPES.values():
            jshape = jax_shapes.SHAPES[shape.name]
            assert shapes.applicable(cfg, shape)[0] == jax_shapes.applicable(jcfg, jshape)[0]
            got = shapes.train_batch_specs(cfg, shape)
            want = jax_shapes.train_batch_specs(jcfg, jshape)
            assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in
                    got.items()} == {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
            assert all(v.device.type == "meta" for v in got.values())
            jsh = jax_shapes.batch_shardings(jcfg, jshape, jmesh, jrules)
            assert {k: _norm(v) for k, v in shapes.batch_shardings(cfg, shape, rules).items()} \
                == {k: _norm(tuple(v.spec) + (None,) * (len(want[k].shape) - len(v.spec)))
                    for k, v in jsh.items()}


def test_meshes_need_a_process_group_and_the_world_to_hold_them(monkeypatch):
    with pytest.raises(RuntimeError, match="process group"):
        launch_mesh.make_test_mesh((1, 1))
    with pytest.raises(RuntimeError, match="process group"):
        launch_mesh.make_production_mesh()
    cpu = torch.device("cpu")
    assert launch_train.build_mesh("none", cpu) is None
    assert launch_train.build_mesh("auto", cpu) is None
    for spec in ("2x2", "3x1", "1x1x1"):
        with pytest.raises(ValueError, match="world"):
            launch_train.build_mesh(spec, cpu)
    with pytest.raises(ValueError, match="DxM"):
        launch_train.build_mesh("two", cpu)
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="one replica"):
        launch_train.build_mesh("none", cpu)
    with pytest.raises(ValueError, match="world"):
        launch_train.build_mesh("2x1", cpu)
