"""Logical -> mesh sharding rules, and the collectives of the mesh path (the
port's copy of the reference's ``parallel/sharding.py``).

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the
reference's axis names: (``data``, ``model``) on one pod, (``pod``,
``data``, ``model``) across pods.  Params carry logical axes
(``core/module.P.axes``: ``fsdp``, ``tp``, ``layers`` ...); ``axis_rules``
maps them onto mesh axes as the reference's does, and ``fit_spec`` drops a
mesh axis that does not divide its dim, which leaves the leaf replicated
over it.  A spec is a plain tuple with one entry a dim: None, an axis name
or a tuple of names.

Where the reference lets XLA place the collectives, the port calls them
itself, each on the process group of its axes:

* FSDP over ``fsdp_axes`` (``data``): a rank keeps the master params and
  the moments of its shard (``ShardingCtx.shard``).  ``gather_view``
  all-gathers each leaf's compute-dtype view once a step (``_GatherLeaf``);
  its backward reduce-scatters the fp32 gradient to the shard's owner.
* head-TP over ``model``: the attention and MLP weights keep the rank's
  heads and columns in the compute view; a layer's input passes
  ``copy_to_model`` (identity forward, all-reduced gradient) and its
  row-parallel output ``reduce_from_model`` (all-reduce forward, identity
  gradient): Megatron's f and g.  The embedding and the LM head are
  gathered whole over ``model`` at use.
* context parallelism over ``model``: the residual stream holds the rank's
  rows of the sequence, every weight is gathered whole, and attention
  all-gathers K/V over ``model`` (``gather_seq``; its backward
  reduce-scatters dK/dV).

Serving on a mesh runs head-TP over the same groups: a rank projects,
caches and attends over its query heads and their K/V heads
(``rank_kv_heads``), and the host decisions that read a clock take rank
0's reading (``ShardingCtx.agree``, a broadcast over a Gloo group of the
mesh's ranks kept beside the device groups, so no device is touched).

A leaf's gradient is summed over the ranks that saw other tokens: the batch
axes, and ``model`` under context parallelism (``ShardingCtx.reduce_axes``,
the reference's ``"tokens"`` rule).  Under head-TP the K/V projections that
every ``model`` rank holds whole (their heads do not divide) are summed over
``model`` too: each rank's gradient covers its query heads' K/V heads only.
Over any other axis every rank computed the same gradient and keeps its
slice of it.

A ``MeshCoords`` stands for one rank of a mesh without a process group:
the rules, ``shard`` and the index math work on it, a collective does not.
"""
from __future__ import annotations

import copy
import itertools
import math
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.config import ModelConfig, ParallelConfig
from repro_torch.core.module import P

BATCH_AXES = ("pod", "data")

Spec = Tuple[Any, ...]


class MeshCoords(NamedTuple):
    """One rank's view of a mesh with no process group behind it:
    ``mesh_dim_names``, ``shape`` and the rank's ``coords``."""

    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    coords: Tuple[int, ...]

    def get_coordinate(self) -> List[int]:
        return list(self.coords)


def mesh_axis_sizes(mesh: Any) -> Dict[str, int]:
    """{axis: size} of a DeviceMesh or a MeshCoords, in mesh order; a dict
    of sizes is taken as it is."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_rules(pc: ParallelConfig, mesh: Any) -> Dict[str, Any]:
    """Logical name -> mesh axis (or tuple of axes), the reference's rules."""
    names = tuple(mesh_axis_sizes(mesh))
    batch_axes: Tuple[str, ...] = BATCH_AXES if "pod" in names else ("data",)
    fsdp = tuple(a for a in pc.fsdp_axes if a in names)
    rules: Dict[str, Any] = {
        "batch": batch_axes,
        "seq": None,
        "seq_cp": "model",
        "embed": None,
        "fsdp": fsdp or None,
        "tp": "model",
        "experts": "model",
        "layers": None,
        "cache_seq": "model",
        "cache_batch": batch_axes,
        "vocab": "model",
        "kv_tp": "model",
        "stats": None,
        # the flattened (batch * seq) token dim of the loss
        "tokens": ((*batch_axes, "model") if pc.attention_parallelism == "context"
                   else batch_axes),
    }
    if len(fsdp) == 1:
        rules["fsdp"] = fsdp[0]
    return rules


def spec(rules: Dict[str, Any], *logical: Optional[str]) -> Spec:
    phys = [rules.get(ax) if ax is not None else None for ax in logical]
    while phys and phys[-1] is None:
        phys.pop()
    return tuple(phys)


def _axes(entry: Any) -> Tuple[str, ...]:
    return () if entry is None else (entry if isinstance(entry, tuple) else (entry,))


def fit_spec(shape: Sequence[int], mesh: Any, pspec: Spec) -> Spec:
    """Drop the mesh axes that do not evenly divide their dim: that dim is
    replicated over them."""
    sizes = mesh_axis_sizes(mesh)
    phys = []
    for dim, ax in zip(shape, tuple(pspec) + (None,) * len(shape)):
        n = math.prod(sizes.get(a, 1) for a in _axes(ax))
        phys.append(ax if ax is not None and dim % n == 0 else None)
    while phys and phys[-1] is None:
        phys.pop()
    return tuple(phys)


def spec_axes(pspec: Spec) -> Tuple[str, ...]:
    """Every mesh axis a spec shards over."""
    return tuple(a for e in pspec for a in _axes(e))


def linear_index(axes: Sequence[str], sizes: Dict[str, int], coords: Dict[str, int]) -> int:
    """The rank's index over ``axes`` taken in mesh order (the order of the
    ranks in their process group)."""
    i = 0
    for a in sorted(axes, key=list(sizes).index):
        i = i * sizes[a] + coords[a]
    return i


def shard_slices(shape: Sequence[int], pspec: Spec, sizes: Dict[str, int],
                 coords: Dict[str, int]) -> Tuple[slice, ...]:
    """The rank's block of a leaf of ``shape`` placed by ``pspec``: along
    each sharded dim, the part at the rank's index over that dim's axes."""
    out = []
    for d, dim in enumerate(shape):
        axes = _axes(pspec[d]) if d < len(pspec) else ()
        n = math.prod(sizes[a] for a in axes)
        if dim % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide over {axes} ({n}); "
                             "fit the spec first")
        step, i = dim // n, linear_index(axes, sizes, coords)
        out.append(slice(i * step, (i + 1) * step))
    return tuple(out)


def shard_shape(shape: Sequence[int], pspec: Spec, sizes: Dict[str, int]) -> Tuple[int, ...]:
    return tuple(dim // math.prod(sizes[a] for a in (_axes(pspec[d]) if d < len(pspec) else ()))
                 for d, dim in enumerate(shape))


# --------------------------------------------------------------------- #
# process groups and collectives
# --------------------------------------------------------------------- #
_GROUPS: Dict[Any, Tuple[Any, Dict[Any, Any]]] = {}


def _mesh_groups(mesh) -> Dict[Tuple[str, ...], Any]:
    """This rank's process group over every nonempty set of mesh axes (in
    mesh order).  Every rank makes every group, in the same order, once a
    mesh layout of a process group.  The mesh's ranks must rise in row-major order (as
    ``init_device_mesh`` lays them out), so that a group's rank order is the
    ranks' index over its axes."""
    names = tuple(mesh.mesh_dim_names)
    ranks = mesh.mesh.cpu()
    world = dist.group.WORLD
    key = (id(world), names, tuple(ranks.shape), tuple(ranks.flatten().tolist()))
    if key in _GROUPS:
        # the entry keeps its world alive, so a later world (after
        # destroy_process_group) cannot take its id
        return _GROUPS[key][1]
    flat = ranks.flatten()
    if not bool((flat[1:] > flat[:-1]).all()):
        raise ValueError(f"the mesh's ranks must rise in row-major order, got {ranks.tolist()}")
    me = dist.get_rank()
    groups: Dict[Any, Any] = {}
    for k in range(1, len(names) + 1):
        for axes in itertools.combinations(names, k):
            dims = [names.index(a) for a in axes]
            rest = [d for d in range(len(names)) if d not in dims]
            rows = ranks.permute(*rest, *dims).reshape(-1, math.prod(ranks.shape[d] for d in dims))
            for row in rows.tolist():
                g = dist.new_group(row)
                if me in row:
                    groups[axes] = g
    # the host group: every rank of the mesh over Gloo, for host values
    # (``ShardingCtx.agree``) whatever the device groups' backend
    groups["host"] = dist.new_group(flat.tolist(), backend="gloo")
    _GROUPS[key] = (world, groups)
    return groups


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim`` (contiguous).
    A group of one gathers ``x`` as it lies: nothing to reorder."""
    n = dist.get_world_size(group)
    if n == 1:
        src = x.contiguous()
        out = torch.empty_like(src)
        dist.all_gather_into_tensor(out, src, group=group)
        return out
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0], *src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of ``x`` over the group, this rank's block along ``dim``."""
    n = dist.get_world_size(group)
    if n == 1:
        src = x.contiguous()
        out = torch.empty_like(src)
        dist.reduce_scatter_tensor(out, src, group=group)
        return out
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


class _CopyTo(torch.autograd.Function):
    """Megatron's f: identity forward, the gradient all-reduced."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity gradient (each rank's
    backward carries its own part of the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    """All-gather along ``dim``; the backward reduce-scatters."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


class _GatherLeaf(torch.autograd.Function):
    """A master shard -> its compute view: cast to ``cdt``, then all-gathered
    along each dim in ``gathers`` ((dim, axes) pairs).  The backward takes
    the gradient to fp32, reduce-scatters it over each gathered dim whose
    axes are summed over (``reduce``) and slices the others (every rank
    computed the same gradient there), all-reduces it over the summed axes
    the leaf is replicated over (``replicated``), and returns it in the
    master dtype."""

    @staticmethod
    def forward(ctx, x, sc, gathers, reduce, replicated, cdt):
        ctx.sc, ctx.gathers, ctx.reduce = sc, gathers, reduce
        ctx.replicated, ctx.dtype = replicated, x.dtype
        y = x.to(cdt)
        for dim, axes in gathers:
            y = _all_gather(y, dim, sc.group(axes))
        return y if y is not x else y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        sc = ctx.sc
        g = g.float()
        for dim, axes in reversed(ctx.gathers):
            if set(axes) <= set(ctx.reduce):
                g = _reduce_scatter(g, dim, sc.group(axes))
            else:
                n = g.shape[dim] // sc.size(axes)
                g = g.narrow(dim, sc.index(axes) * n, n)
        if ctx.replicated:
            g = _all_reduce(g, sc.group(ctx.replicated))
        return g.contiguous().to(ctx.dtype), None, None, None, None, None


# --------------------------------------------------------------------- #
# the context
# --------------------------------------------------------------------- #
_ATTN = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
_MLP = ("w_in", "w_gate", "w_out", "b_in")
_KV = ("wk", "wv", "bk", "bv")


class LeafSpec(NamedTuple):
    """Where a leaf lives: ``store`` shards the master copy and the moments,
    ``compute`` the compute view a step works on (the store spec without the
    axes the view is gathered over); ``reduce`` is the axes its gradient is
    summed over."""

    store: Spec
    compute: Spec
    reduce: Tuple[str, ...]


class ShardingCtx:
    """The mesh, its rules and this rank's place on it; threaded through the
    model's layers.  ``mesh=None`` (the mesh-free model) makes every mesh
    path inactive.  ``mesh`` is a DeviceMesh, or a ``MeshCoords`` for the
    index math alone."""

    def __init__(self, mesh: Any, pc: ParallelConfig):
        self.mesh = mesh
        self.pc = pc
        self.rules = axis_rules(pc, mesh) if mesh is not None else {}
        self.sizes = mesh_axis_sizes(mesh) if mesh is not None else {}
        self.coords = dict(zip(self.sizes, mesh.get_coordinate())) if mesh is not None else {}
        self._groups = (_mesh_groups(mesh) if mesh is not None
                        and not isinstance(mesh, MeshCoords) else {})
        # the mesh origin's global rank: the source of ``agree``
        self._origin = int(mesh.mesh.flatten()[0]) if self._groups else 0
        # serving: every data rank holds the same rows (``serving``)
        self.batch_replicated = False

    def serving(self) -> "ShardingCtx":
        """This rank's context for the serving entry points: the same mesh
        and groups, the batch's rows replicated over the batch axes (the
        data ranks serve the same requests as replicas), so no layer sums
        or orders rows across them (the MoE layer's capacity and router
        statistics are then the mesh-free layer's)."""
        c = copy.copy(self)
        c.batch_replicated = True
        return c

    # ---------------------------------------------------------- the layout
    @property
    def context_parallel(self) -> bool:
        return self.pc.attention_parallelism == "context"

    @property
    def tp(self) -> int:
        """The ``model`` axis's size (1 off-mesh)."""
        return self.sizes.get("model", 1)

    @property
    def head_tp(self) -> bool:
        """Attention heads and MLP columns sharded over ``model``."""
        return self.tp > 1 and not self.context_parallel

    @property
    def seq_parallel(self) -> bool:
        """The residual stream's sequence sharded over ``model``."""
        return self.tp > 1 and self.context_parallel

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in BATCH_AXES if a in self.sizes)

    @property
    def reduce_axes(self) -> Tuple[str, ...]:
        """The axes whose ranks see other tokens: a gradient sums over them."""
        return self.batch_axes + (("model",) if self.context_parallel and "model" in self.sizes
                                  else ())

    @property
    def data_ranks(self) -> int:
        """How many parts the batch's rows are split into."""
        return self.size(self.batch_axes)

    @property
    def is_first(self) -> bool:
        """The rank at the mesh's origin: it prints and writes files."""
        return all(c == 0 for c in self.coords.values())

    def size(self, axes: Sequence[str]) -> int:
        return math.prod(self.sizes[a] for a in axes)

    def index(self, axes: Sequence[str]) -> int:
        return linear_index(axes, self.sizes, self.coords)

    def group(self, axes: Sequence[str]):
        names = tuple(self.sizes)
        key = tuple(sorted(axes, key=names.index))
        if key not in self._groups:
            raise RuntimeError(f"no process group over {key}: the mesh is {self.mesh!r}")
        return self._groups[key]

    def sp(self, *logical: Optional[str]) -> Spec:
        return spec(self.rules, *logical) if self.mesh is not None else ()

    def seq_chunk(self, S: int) -> Tuple[int, int]:
        """(first row, rows) of the rank's part of an S-row sequence under
        context parallelism; the whole sequence otherwise."""
        if not self.seq_parallel:
            return 0, S
        if S % self.tp:
            raise ValueError(f"context parallelism splits the sequence over model={self.tp}: "
                             f"{S} rows do not divide")
        n = S // self.tp
        return self.coords["model"] * n, n

    def batch_rows(self, x, accum: int = 1):
        """The rank's rows of a global batch leaf (its leading dim), such that
        micro-batch i of the rank's rows (``accum`` of them) is the rank's
        block of the global batch's micro-batch i."""
        n = self.data_ranks
        if n == 1:
            return x
        B = x.shape[0]
        if B % (accum * n):
            raise ValueError(f"global batch {B} does not split into {accum} micro-batch(es) "
                             f"over {n} data rank(s)")
        k = B // (accum * n)
        i = self.index(self.batch_axes)
        return x.reshape(accum, n, k, *x.shape[1:])[:, i].reshape(accum * k, *x.shape[1:])

    # ------------------------------------------------------ leaf placement
    def _tp_leaf(self, path: Tuple[str, ...], cfg: ModelConfig) -> bool:
        """Does head-TP keep this leaf sharded over ``model`` in the compute
        view: a self-attention projection (the K/V ones only when the kv
        heads divide) or a dense MLP weight whose d_ff divides."""
        if len(path) < 2:
            return False
        owner, name = path[-2], path[-1]
        if owner == "attn" and name in _ATTN:
            return name not in _KV or cfg.num_kv_heads % self.tp == 0
        return owner == "ffn" and name in _MLP and cfg.d_ff % self.tp == 0

    def leaf_spec(self, path: Tuple[str, ...], p: P, cfg: ModelConfig) -> LeafSpec:
        store = fit_spec(p.shape, self.sizes, spec(self.rules, *p.axes))
        keep_model = self.head_tp and self._tp_leaf(path, cfg)
        compute = tuple(e if e is not None and (keep_model and _axes(e) == ("model",)) else None
                        for e in store)
        while compute and compute[-1] is None:
            compute = compute[:-1]
        reduce = self.reduce_axes
        if self.head_tp and path[-2:-1] == ("attn",) and path[-1] in _KV and not keep_model:
            reduce = reduce + ("model",)
        return LeafSpec(store, compute, reduce)

    def param_specs(self, defs: Dict[str, Any], cfg: ModelConfig, path=()) -> Dict[str, Any]:
        """``LeafSpec`` of every leaf of a P-tree."""
        if isinstance(defs, dict):
            return {k: self.param_specs(v, cfg, path + (k,)) for k, v in defs.items()}
        return self.leaf_spec(path, defs, cfg)

    def shard(self, x: torch.Tensor, store: Spec) -> torch.Tensor:
        """The rank's block of a whole leaf, in memory of its own."""
        if not spec_axes(store):
            return x
        return x[shard_slices(x.shape, store, self.sizes, self.coords)].clone(
            memory_format=torch.contiguous_format)

    def shard_tree(self, specs: Dict[str, Any], params: Dict[str, Any],
                   defs: Dict[str, Any]) -> Dict[str, Any]:
        """Each leaf of ``params`` as its shard: a whole leaf (the P's shape)
        is sliced, a leaf of the shard's shape is kept."""
        if isinstance(specs, dict):
            return {k: self.shard_tree(specs[k], params[k], defs[k]) for k in specs}
        whole = tuple(defs.shape)
        local = shard_shape(whole, specs.store, self.sizes)
        if tuple(params.shape) == whole:
            return self.shard(params, specs.store)
        if tuple(params.shape) == local:
            return params
        raise ValueError(f"a leaf of shape {tuple(params.shape)} is neither whole {whole} nor "
                         f"this rank's shard {local}")

    def owns(self, store: Spec) -> bool:
        """Does this rank count its shard of a leaf in a sum over distinct
        elements: it sits at coordinate 0 of every axis the leaf is
        replicated over."""
        sharded = spec_axes(store)
        return all(c == 0 for a, c in self.coords.items() if a not in sharded)

    # ------------------------------------------------------------ the views
    def gather_leaf(self, x: torch.Tensor, ls: LeafSpec, cdt: torch.dtype) -> torch.Tensor:
        """A master shard's compute view (differentiable; see ``_GatherLeaf``)."""
        gathers = tuple((d, _axes(e)) for d, e in enumerate(ls.store)
                        if e is not None and (d >= len(ls.compute) or ls.compute[d] is None))
        sharded = spec_axes(ls.store)
        replicated = tuple(a for a in ls.reduce if a not in sharded)
        return _GatherLeaf.apply(x, self, gathers, ls.reduce, replicated, cdt)

    def gather_view(self, specs: Dict[str, Any], params: Dict[str, Any],
                    cdt: torch.dtype) -> Dict[str, Any]:
        if isinstance(specs, dict):
            return {k: self.gather_view(specs[k], params[k], cdt) for k in specs}
        return self.gather_leaf(params, specs, cdt)

    @torch.no_grad()
    def gather_whole(self, x: torch.Tensor, store: Spec) -> torch.Tensor:
        """A shard -> the whole leaf on every rank (no gradient)."""
        for d, e in enumerate(store):
            if e is not None:
                x = _all_gather(x, d, self.group(_axes(e)))
        return x

    # ------------------------------------------------------ the collectives
    def copy_to_model(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyTo.apply(x, self.group(("model",)))

    def reduce_from_model(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceFrom.apply(x, self.group(("model",)))

    def gather_seq(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        return _GatherSeq.apply(x, dim, self.group(("model",)))

    def reduce_sum(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """The sum over ``axes`` of a value each rank holds its part of; the
        gradient of each part is its rank's own (Megatron's g)."""
        return _ReduceFrom.apply(x, self.group(axes))

    @torch.no_grad()
    def all_reduce(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        return _all_reduce(x, self.group(axes))

    @torch.no_grad()
    def all_gather(self, x: torch.Tensor, axes: Sequence[str], dim: int = 0) -> torch.Tensor:
        return _all_gather(x, dim, self.group(axes))

    def barrier(self) -> None:
        dist.barrier(group=self.group(tuple(self.sizes)))

    def agree(self, x: float) -> float:
        """The mesh origin's ``x`` on every rank: one broadcast of a host
        value over the host group (Gloo, CPU memory).  Off a process group
        (no mesh, a ``MeshCoords``) ``x`` itself."""
        if not self._groups:
            return x
        buf = np.array([x], dtype=np.float64)
        dist.broadcast(torch.from_numpy(buf), src=self._origin, group=self._groups["host"])
        return float(buf[0])


def rank_kv_heads(cfg: ModelConfig, ctx: Any) -> List[int]:
    """The K/V heads (indices into the model's) that a head-TP rank
    projects, caches and attends with: its block of ``num_kv_heads / tp``
    where they divide over ``model``; else, every K/V head being
    replicated, those of its query heads: the one head when they fall in
    one group, else one per query head (a head may repeat).  Every head off
    head-TP (no mesh, ``model`` of 1, context parallelism)."""
    if ctx is None or not ctx.head_tp:
        return list(range(cfg.num_kv_heads))
    r, tp = ctx.coords["model"], ctx.tp
    if cfg.num_kv_heads % tp == 0:
        n = cfg.num_kv_heads // tp
        return list(range(r * n, (r + 1) * n))
    heads = cfg.num_heads // tp
    g = cfg.num_heads // cfg.num_kv_heads
    idx = [(r * heads + i) // g for i in range(heads)]
    return idx[:1] if len(set(idx)) == 1 else idx


def null_ctx() -> ShardingCtx:
    return ShardingCtx(None, ParallelConfig())
