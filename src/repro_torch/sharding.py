"""Logical-axis sharding rules for the port's meshes, the port of
``repro.sharding`` on ``torch.distributed``.

Physical meshes (see :mod:`repro_torch.launch.mesh`):

* single-pod: ``(16, 16)`` over ``("data", "model")``
* multi-pod:  ``(2, 16, 16)`` over ``("pod", "data", "model")``
* training on the local group: ``(world / mp, mp)`` over ``("data",
  "model")``

Policy (the reference's rule table, entry for entry):

* **FSDP** — parameters, gradients and optimizer moments are sharded over
  the data axes on the dimension *not* used for tensor parallelism.  The
  eager step stores each leaf as a DTensor of its block and gathers it
  whole at use (ZeRO-3): a layer's leaves inside that layer's recompute,
  so the gathered copy lives for one layer and is gathered again in the
  backward, whose gradient leaves as a sum over the batch axes scattered
  back to the blocks.  The gather runs over plain collectives
  (:class:`_Gather`): DTensor's own ``full_tensor`` cost 275 ms of host
  time a step at minicpm-2b's 362 leaves on an H100 host, and under gloo
  on CUDA tensors it ends the ranks with SIGSEGV.
* **TP** — the flattened head / ffn / expert / vocabulary dimensions are
  sharded over ``model``.  The training loss splits their compute
  (Megatron's scheme, :class:`ModelSplit`): each model rank keeps its
  block of those leaves (``gather(..., keep_model=True)``) and computes
  only that block — column-parallel ``wq`` / ``wk`` / ``wv`` /
  ``wi_*`` / ``xw{q,k,v}`` and the head, row-parallel ``wo`` /
  ``wo_mlp`` / ``dwo`` / ``xwo``, attention over the heads its block of
  ``wo``'s input overlaps, the embedding's rows and the loss's logits
  over its vocabulary block, its experts — with copy-in and reduce-out
  making the function the one-process one.  Serving (``prefill`` /
  ``decode_step`` under a policy) splits the same way: a row-parallel
  STaMP site's per-token min / max is its block's, all-reduced over
  ``model`` (:meth:`ModelSplit.minmax`) before the quantize, a fused
  site's int32 products are summed before its one epilogue
  (:meth:`ModelSplit.sum`: one device's output, bit for bit), and the
  decode cache's sequence is split over a :class:`SeqGroup` (context
  parallel: each rank attends over its block and the partial softmax
  states are merged in rank order).  A Mamba mixer splits over its
  heads: ``in_proj`` column-parallel over this rank's ``[z | x | B | C |
  dt]`` parts (B and C whole: one group, every head reads them; the
  rule table's block of the flat columns is gathered and cut by part),
  the conv over its channels, the SSD over its heads, the gated norm's
  per-head sums of squares gathered over ``model``, ``out_proj``
  row-parallel; its SSM state and conv cache are its heads' and
  channels' blocks.
* **Sequence parallelism** — ``seq_sharded`` keeps the reference's spec
  values (the residual's sequence over ``model``); the eager step refuses
  it.

The port's parameter tree is unrolled (``layers/3/wq``) where the
reference's is stacked (``period/0/wq`` with a leading period axis mapped
to ``None``): a leaf's spec is the reference's for its stacked
counterpart with that leading ``None`` dropped, which is what the rule
table gives for the leaf's own rank.  A spec becomes DTensor placements
(:func:`placements`): ``Shard(d)`` on each mesh axis named at tensor dim
``d``, ``Replicate()`` on the others.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch import tree as TR

Pytree = Any


class PartitionSpec(tuple):
    """Per tensor dim: a mesh axis name, a tuple of names (the dim split
    over their product, the first name major) or ``None``.  Entries are
    normalized as jax's ``PartitionSpec`` normalizes them: a one-name
    tuple is the bare name, an empty one ``None``."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


P = PartitionSpec


def _axes(entry) -> tuple:
    return () if entry is None else (entry,) if isinstance(entry, str) \
        else tuple(entry)


def placements(mesh: DeviceMesh, spec: PartitionSpec) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: one per mesh dim,
    ``Shard(d)`` where the dim's axis is named at tensor dim ``d``.  Two
    axes on one tensor dim must come in the mesh's order (``("pod",
    "data")``), as DTensor nests them."""
    names = mesh.mesh_dim_names
    out = [Replicate()] * mesh.ndim
    for d, entry in enumerate(spec):
        last = -1
        for ax in _axes(entry):
            if ax not in names:
                raise ValueError(f"{spec}: the mesh {names} has no axis "
                                 f"{ax!r}")
            i = names.index(ax)
            if i <= last or not isinstance(out[i], Replicate):
                raise ValueError(f"{spec}: axis {ax!r} out of the mesh's "
                                 f"order {names} or used twice")
            out[i] = Shard(d)
            last = i
    return tuple(out)


def _row_major(shape) -> tuple:
    stride, out = 1, []
    for n in reversed(tuple(shape)):
        out.append(stride)
        stride *= n
    return tuple(reversed(out))


def axis_size(mesh: DeviceMesh, axes) -> int:
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                     for a in _axes(axes))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""
    mesh: DeviceMesh
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)

    def shard_shape(self, shape) -> tuple:
        """Every rank's block shape.  An axis product that does not divide
        its dim is refused, as the reference's ``shard_shape`` refuses
        it."""
        shape = tuple(shape)
        out = list(shape)
        for d, entry in enumerate(self.spec):
            n = axis_size(self.mesh, entry)
            if shape[d] % n:
                raise ValueError(f"dim {d} of {shape} does not split "
                                 f"{n} ways ({self.spec})")
            out[d] = shape[d] // n
        return tuple(out)

    def shard(self, full: torch.Tensor, device=None) -> DTensor:
        """This rank's block of ``full`` (sliced where it lies, then copied
        to ``device``: it never shares ``full``'s storage) as a DTensor of
        ``full``'s shape."""
        block = self.shard_shape(full.shape)
        coord = self.mesh.get_coordinate()
        names = self.mesh.mesh_dim_names
        local = full
        for d, entry in enumerate(self.spec):
            idx = 0
            for ax in _axes(entry):
                i = names.index(ax)
                idx = idx * self.mesh.size(i) + coord[i]
            if entry is not None:
                local = local.narrow(d, idx * block[d], block[d])
        local = local.detach().to(device if device is not None
                                  else full.device, copy=True)
        return DTensor.from_local(local.contiguous(), self.mesh,
                                  self.placements, run_check=False,
                                  shape=full.shape,
                                  stride=_row_major(full.shape))


# ---------------------------------------------------------------------------
# helpers on a tree's leaves (plain tensors pass through)
# ---------------------------------------------------------------------------


def local(t):
    """The rank's block of a DTensor; a plain tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def like(ref, t: torch.Tensor):
    """``t`` (a local block) as a DTensor placed as ``ref``, or ``t``
    when ``ref`` is a plain tensor."""
    if not isinstance(ref, DTensor):
        return t
    return DTensor.from_local(t, ref.device_mesh, ref.placements,
                              run_check=False, shape=ref.shape,
                              stride=ref.stride())


def _mesh_of(leaves: list) -> Optional[DeviceMesh]:
    for t in leaves:
        if isinstance(t, DTensor):
            return t.device_mesh
    return None


def sum_over_shards(values: list, leaves: list) -> list:
    """Each leaf's total from its blocks' ``values`` (one 0-d tensor a
    leaf): summed over the mesh dims the leaf is sharded on, counted once
    over those it is replicated on (only coordinate 0 of a replicated dim
    contributes).  One all-reduce a mesh dim; ``values`` unchanged when no
    leaf is a DTensor."""
    mesh = _mesh_of(leaves)
    if mesh is None:
        return values
    coord = mesh.get_coordinate()

    def owner(t):
        pl = t.placements if isinstance(t, DTensor) else \
            (Replicate(),) * mesh.ndim
        return all(c == 0 for c, p in zip(coord, pl)
                   if isinstance(p, Replicate))
    vec = torch.stack(values) * torch.tensor(
        [1.0 if owner(t) else 0.0 for t in leaves], device=values[0].device)
    for i in range(mesh.ndim):
        dist.all_reduce(vec, group=mesh.get_group(i))
    return list(vec.unbind())


def max_over_shards(values: list, leaves: list) -> list:
    """Each leaf's largest value from its blocks' ``values``."""
    mesh = _mesh_of(leaves)
    if mesh is None:
        return values
    vec = torch.stack(values)
    for i in range(mesh.ndim):
        dist.all_reduce(vec, op=dist.ReduceOp.MAX, group=mesh.get_group(i))
    return list(vec.unbind())


def _all_gather(x: torch.Tensor, dim: int, n: int, group) -> torch.Tensor:
    """The ``n`` ranks' blocks of ``group`` concatenated along ``dim``."""
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(x: torch.Tensor, dim: int, n: int, group
                    ) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``group``'s ``x``."""
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim).contiguous()


def _whole(local: torch.Tensor, mesh: DeviceMesh, pl: tuple
           ) -> torch.Tensor:
    """The whole tensor from this rank's block: each sharded mesh dim's
    blocks gathered, the innermost first (DTensor nests a dim sharded on
    two mesh dims with the first major).  A mesh dim of one rank moves
    nothing."""
    for i in reversed(range(mesh.ndim)):
        n = mesh.size(i)
        if isinstance(pl[i], Shard) and n > 1:
            local = _all_gather(local, pl[i].dim, n, mesh.get_group(i))
    return local


class _Gather(torch.autograd.Function):
    """ZeRO-3's gather at use over plain collectives.  Forward: the tensor
    from this rank's block, whole along every mesh dim but those ``keep``
    names (their block stays).  Backward: the gradient summed over the
    batch mesh dims (each rank ran its own rows) and taken as computed
    over the others (their compute is replicated, or split and the block
    kept), then cut to this rank's block: a reduce-scatter (or an
    all-reduce where the leaf is replicated) on a batch dim, a slice on
    another gathered one, outermost first."""

    @staticmethod
    def forward(ctx, local, mesh, pl, batch, keep):
        ctx.mesh, ctx.pl, ctx.batch = mesh, pl, batch
        pl = tuple(Replicate() if k else p for p, k in zip(pl, keep))
        ctx.gathered = pl
        return _whole(local, mesh, pl)

    @staticmethod
    def backward(ctx, grad):
        mesh, pl = ctx.mesh, ctx.pl
        coord = mesh.get_coordinate()
        for i in range(mesh.ndim):
            n = mesh.size(i)
            if n == 1:
                continue
            shard = pl[i].dim if isinstance(pl[i], Shard) else None
            if ctx.batch[i] and shard is not None:
                grad = _reduce_scatter(grad, shard, n, mesh.get_group(i))
            elif ctx.batch[i]:
                grad = grad.contiguous()
                dist.all_reduce(grad, group=mesh.get_group(i))
            elif isinstance(ctx.gathered[i], Shard):
                grad = grad.chunk(n, dim=shard)[coord[i]]
        return grad.contiguous(), None, None, None, None


def gather_full(t: torch.Tensor) -> torch.Tensor:
    """A leaf whole on every rank, outside autograd (checkpoints, CRCs)."""
    if not isinstance(t, DTensor):
        return t
    with torch.no_grad():
        return _whole(t.to_local(), t.device_mesh, t.placements)


class _CopyIn(torch.autograd.Function):
    """Megatron's ``f``: the identity forward; the gradient all-reduced
    over the model group backward (each model rank's block of the
    computation that follows gives a part of the input's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceOut(torch.autograd.Function):
    """Megatron's ``g``: the model ranks' partial results all-reduced
    forward (in place: the partial is a fresh product no other node
    keeps); the gradient, alike on every model rank, passed on unchanged
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.mark_dirty(x)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherModel(torch.autograd.Function):
    """The model ranks' blocks concatenated along ``dim`` forward; this
    rank's block of the summed gradient (a reduce-scatter) backward."""

    @staticmethod
    def forward(ctx, x, dim, n, group):
        ctx.dim, ctx.n, ctx.group = dim, n, group
        return _all_gather(x, dim, n, group)

    @staticmethod
    def backward(ctx, grad):
        return (_reduce_scatter(grad, ctx.dim, ctx.n, ctx.group), None,
                None, None)


@dataclasses.dataclass(frozen=True)
class ModelSplit:
    """This rank's share of the ``model`` axis in the split training and
    serving steps: the axis's process ``group``, this rank's index
    ``rank`` on it and its ``size`` (more than one).  The layer functions
    take it (``None``: the computation whole, as on one device).
    ``f32_parts`` (serving): a row-parallel product's partial is kept in
    f32 and the sum rounded once, as one device rounds its product; the
    training step's partials are rounded to the activations' dtype
    before the sum (f32 ones would add 10% (minicpm-2b) to 40% (Arctic)
    to the collective bytes of the dry run's train_4k step, and move its
    row-parallel products and their gradients to f32:
    ``tools/f32_parts_cost.py``)."""
    group: Any
    rank: int
    size: int
    f32_parts: bool = False

    def block(self, n: int) -> tuple:
        """``[start, stop)`` of this rank's block of a dim of ``n`` split
        over the axis; a dim the axis does not divide is refused, as
        :meth:`NamedSharding.shard_shape` refuses it."""
        if n % self.size:
            raise ValueError(f"a dim of {n} does not split {self.size} "
                             f"ways over 'model'")
        b = n // self.size
        return self.rank * b, (self.rank + 1) * b

    def local_ids(self, ids: torch.Tensor, n: int) -> tuple:
        """``ids`` into a dim of ``n`` (a vocabulary) against this rank's
        block of it: the ids made local to the block and clamped into it,
        and the mask of those the block holds."""
        v0, v1 = self.block(n)
        local = ids.long() - v0
        mine = (local >= 0) & (local < v1 - v0)
        return local.clamp(0, v1 - v0 - 1), mine

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyIn.apply(x, self.group)

    def reduce_out(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceOut.apply(x, self.group)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _GatherModel.apply(x, dim % x.dim(), self.size, self.group)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise largest of the ranks' ``x``, outside autograd."""
        x = x.detach().clone()
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.group)
        return x

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise sum of the ranks' ``x``, in place, outside
        autograd: exact for integers (K2's int32 parts)."""
        dist.all_reduce(x, group=self.group)
        return x

    def minmax(self, mn: torch.Tensor, mx: torch.Tensor) -> tuple:
        """The elementwise least of the ranks' ``mn`` and largest of their
        ``mx`` in one all-reduce (``MAX`` over ``[-mn, mx]``: a negation
        is exact, and gloo's ``MAX`` takes CUDA tensors), outside
        autograd: a row-parallel block's per-row statistics made the whole
        row's."""
        v = torch.stack([-mn.detach(), mx.detach()])
        dist.all_reduce(v, op=dist.ReduceOp.MAX, group=self.group)
        return -v[0], v[1]


@dataclasses.dataclass(frozen=True)
class SeqGroup:
    """The ranks a serving cache's sequence is split over, as the
    reference's ``cache_shardings`` / ``decode_kv_spec`` split it:
    ``model``, or every mesh axis where the global batch is smaller than
    the batch axes (long-context decode: the batch is replicated and the
    sequence is the only parallel dim left).  ``rank`` is this rank's
    index over those axes (``model`` minor), ``size`` their product;
    ``model_rank`` / ``model_size`` its place on ``model`` alone.  A
    region of the cache (the hi codes, the lo codes, the cross-attention
    ``xk`` / ``xv``) is split as the reference's ``fit_seq`` splits it
    (:meth:`region`)."""
    group: Any
    rank: int
    size: int
    model_rank: int
    model_size: int

    def region(self, n: int) -> tuple:
        """``(first position, positions, attends)`` of this rank's block of
        a region of ``n`` positions: over the whole group where it divides
        ``n``, else over ``model`` alone (the block replicated over the
        batch axes), else whole.  ``attends``: this rank is the one copy
        of its block that attention reads (a block held on several ranks
        is read on the first of them), so the group's partial softmax
        states count every position once."""
        if n % self.size == 0:
            c = n // self.size
            return self.rank * c, c, True
        if n % self.model_size == 0:
            c = n // self.model_size
            return self.model_rank * c, c, self.rank // self.model_size == 0
        return 0, n, self.rank == 0

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The group's ``x`` stacked in rank order on a new leading dim."""
        return _all_gather(x.detach()[None], 0, self.size, self.group)


class _BatchSum(torch.autograd.Function):
    """The sum of a per-rank term over the batch axes; the gradient
    reaches each rank's own term unchanged (each rank differentiates the
    global value with respect to its own rows)."""

    @staticmethod
    def forward(ctx, x, groups):
        out = x.clone()
        for g in groups:
            dist.all_reduce(out, group=g)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


# ---------------------------------------------------------------------------
# the policy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    mesh: DeviceMesh
    multi_pod: bool = False
    seq_sharded: bool = False          # Megatron-SP-style residual sharding
    fsdp_over_pod: bool = True         # include 'pod' in the FSDP axes
    serve_replicated_weights: bool = False   # inference: drop the FSDP axis

    @property
    def batch_axes(self):
        return ("pod", "data") if self.multi_pod else ("data",)

    @property
    def fsdp_axes(self):
        if self.serve_replicated_weights:
            return ()
        if self.multi_pod and self.fsdp_over_pod:
            return ("pod", "data")
        return "data"

    # -- parameter rules ---------------------------------------------------

    def param_spec(self, path: str, ndim: int) -> PartitionSpec:
        """Rule table keyed on parameter-tree path substrings, in the
        reference's order.  Packed-int4 serving weights (``…/wq/q``,
        ``…/wq/scale``) and fused-path prepared weights (``…/wq/iq``,
        ``…/wq/isw``, ``…/wq/izw``) inherit the parent weight's rule
        (scale / zp / isw / izw have a broadcast leading dim).  Leading
        dims the rule does not name map to ``None``."""
        fsdp, tp = self.fsdp_axes, "model"
        packed_leaf = None
        for suffix in ("/q", "/scale", "/zp", "/iq", "/isw", "/izw"):
            if path.endswith(suffix):
                packed_leaf = suffix[1:]
                path = path[: -len(suffix)]
                break
        rules = [
            # embeddings / lm head
            (r"embed$", P(tp, fsdp)),
            (r"head$", P(fsdp, tp)),
            # attention projections (flat head dims; wqkv = fused-path
            # concatenated self-attention weights, same layout)
            (r"(wq|wk|wv|wqkv|xwq|xwk|xwv)$", P(fsdp, tp)),
            (r"(wo|xwo)$", P(tp, fsdp)),
            (r"(bq|bk|bv)$", P(tp)),
            # dense mlp
            (r"(wi_gate|wi_up|dwi_gate|dwi_up)$", P(fsdp, tp)),
            (r"(wo_mlp|dwo)$", P(tp, fsdp)),
            # moe — expert axis over 'model' (expert-parallel)
            (r"gate_w$", P(fsdp, None)),
            (r"(we_gate|we_up)$", P(tp, fsdp, None)),
            (r"we_down$", P(tp, None, fsdp)),
            # mamba
            (r"in_proj$", P(fsdp, tp)),
            (r"out_proj$", P(tp, fsdp)),
            (r"(conv_w|a_log|d_skip|dt_bias|ssm_norm)$", P()),
            # norms / scalars
            (r"(ln1|ln2|lnx|final_norm|enc_final_norm)$", P()),
        ]
        spec = P()
        for pat, s in rules:
            if re.search(pat, path):
                spec = s
                break
        if packed_leaf in ("scale", "zp", "isw", "izw") and len(spec) >= 2:
            # (…, 1, dout): keep only the output-dim sharding
            spec = P(*spec[:-2], None, spec[-1])
        extra = ndim - len(spec)
        if extra > 0:
            spec = P(*([None] * extra), *spec)
        return spec

    def params_shardings(self, params: Pytree) -> Pytree:
        """A :class:`NamedSharding` for every leaf of the port's tree,
        named by its path (``layers/3/wq``)."""
        flat = TR.flatten_with_paths(params)
        return TR.unflatten_like(params, [
            self.named(self.param_spec(TR.path_name(path), leaf.dim()))
            for path, leaf in flat])

    # -- activation / data rules -------------------------------------------

    def named(self, spec: PartitionSpec) -> NamedSharding:
        return NamedSharding(self.mesh, spec)

    def tokens(self) -> PartitionSpec:
        return P(self.batch_axes, None)

    def acts(self) -> PartitionSpec:
        """Residual-stream constraint between blocks."""
        if self.seq_sharded:
            return P(self.batch_axes, "model", None)
        return P(self.batch_axes, None, None)

    def frontend_embeds(self) -> PartitionSpec:
        return P(self.batch_axes, None, None)

    def kv_cache(self) -> PartitionSpec:
        """(periods, b, s, kv, hd)-style caches: batch over data, sequence
        over model (context-parallel decode)."""
        return P(None, self.batch_axes, "model", None, None)

    def kv_cache_packed(self) -> PartitionSpec:
        return self.kv_cache()

    def kv_scale(self) -> PartitionSpec:
        return P(None, self.batch_axes, "model", None)

    def decode_kv_spec(self, global_batch: int) -> PartitionSpec:
        """(b, s, kv, hd) dequantized cache slice during decode: the
        sequence axis context-parallel."""
        if global_batch >= axis_size(self.mesh, self.batch_axes):
            return P(self.batch_axes, "model", None, None)
        return P(None, tuple(self.batch_axes) + ("model",), None, None)

    def ssm_state(self) -> PartitionSpec:
        # (periods, [pos,] b, h, p, n): batch over data, heads over model
        return P(None, self.batch_axes, "model", None, None)

    def conv_cache(self) -> PartitionSpec:
        return P(None, self.batch_axes, None, "model")

    def constraint(self, x: torch.Tensor, spec: PartitionSpec):
        """The eager step holds a tensor as the rows of its batch shard,
        every other dim whole: a spec that splits along another axis
        (``seq_sharded``'s residual) is refused."""
        for entry in spec:
            if any(ax not in self.batch_axes for ax in _axes(entry)):
                raise NotImplementedError(
                    f"the eager step splits only the batch: {spec} asks "
                    f"for more (sequence-sharded activations are the dry "
                    f"run's)")
        return x

    # -- the eager step's placement ----------------------------------------

    def place(self, tree: Pytree, device=None) -> Pytree:
        """Each leaf of a full tree (parameters or a parameter-shaped
        state) as its block on this rank, by the rule table."""
        return TR.tree_map(lambda t, sh: sh.shard(t, device), tree,
                           self.params_shardings(tree))

    def gather(self, tree: Pytree, keep_model: bool = False) -> Pytree:
        """Each DTensor leaf whole (plain tensors pass through), its
        gradient summed over the batch axes and scattered back to the
        leaf's blocks (:class:`_Gather`).  With ``keep_model`` the leaf
        is gathered over the batch axes only: a leaf sharded along
        ``model`` stays this rank's block, for a computation split as
        :class:`ModelSplit` splits it."""
        names = self.mesh.mesh_dim_names
        batch = tuple(n in self.batch_axes for n in names)
        keep = tuple(keep_model and n == "model" for n in names)
        return TR.tree_map(
            lambda t: _Gather.apply(t.to_local(), t.device_mesh,
                                    t.placements, batch, keep)
            if isinstance(t, DTensor) else t, tree)

    def model_split(self) -> Optional[ModelSplit]:
        """This rank's :class:`ModelSplit`, or ``None`` when ``model`` has
        one rank (nothing to split: the step is the one-device one)."""
        i = self.mesh.mesh_dim_names.index("model")
        n = self.mesh.size(i)
        if n == 1:
            return None
        return ModelSplit(self.mesh.get_group(i),
                          self.mesh.get_coordinate()[i], n)

    def seq_group(self, global_batch: Optional[int] = None
                  ) -> Optional[SeqGroup]:
        """The serving cache's :class:`SeqGroup`: ``model``, or every axis
        of the mesh when ``global_batch`` is below the batch axes' size
        (the reference's ``decode_kv_spec`` / ``cache_shardings``);
        ``None`` when that is one rank."""
        names = self.mesh.mesh_dim_names
        i = names.index("model")
        coord = self.mesh.get_coordinate()
        n_model = self.mesh.size(i)
        if global_batch is None or \
                global_batch >= axis_size(self.mesh, self.batch_axes):
            if n_model == 1:
                return None
            return SeqGroup(self.mesh.get_group(i), coord[i], n_model,
                            coord[i], n_model)
        if self.mesh.size() == 1:
            return None
        # every axis: the mesh's own ranks, model minor (the mesh's last
        # axis), as the whole process group orders them
        idx = 0
        for d, c in enumerate(coord):
            idx = idx * self.mesh.size(d) + c
        if names[-1] != "model" or idx != dist.get_rank() or \
                self.mesh.size() != dist.get_world_size():
            raise NotImplementedError(
                "a cache split over every axis needs the mesh to be the "
                "whole process group in rank order, model last")
        return SeqGroup(dist.group.WORLD, idx, self.mesh.size(), coord[i],
                        n_model)

    def _batch_index(self) -> tuple:
        coord = self.mesh.get_coordinate()
        names = self.mesh.mesh_dim_names
        idx = 0
        for ax in self.batch_axes:
            i = names.index(ax)
            idx = idx * self.mesh.size(i) + coord[i]
        return idx, axis_size(self.mesh, self.batch_axes)

    def batch_rows(self, batch: dict) -> dict:
        """This rank's rows of a global batch (a dict of arrays or
        tensors, batch first)."""
        idx, n = self._batch_index()
        out = {}
        for k, v in batch.items():
            if v.shape[0] % n:
                raise ValueError(f"a global batch of {v.shape[0]} rows "
                                 f"does not split over {n} data ranks")
            rows = v.shape[0] // n
            out[k] = v[idx * rows:(idx + 1) * rows]
        return out

    def batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the batch axes' ranks (see
        :class:`_BatchSum`)."""
        names = self.mesh.mesh_dim_names
        return _BatchSum.apply(x, [self.mesh.get_group(names.index(a))
                                   for a in self.batch_axes])


def constrain(x, policy: Optional[ShardingPolicy], spec_fn):
    """No-op when no policy is supplied (single-device runs)."""
    if policy is None:
        return x
    return policy.constraint(x, spec_fn(policy))
