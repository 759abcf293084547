"""Per-device op statistics of an eager PyTorch step, the twin of
``repro.analysis.hlo.analyze_hlo_text`` for a program that has no HLO.

:class:`OpCounter` is a ``TorchDispatchMode``: run a step under it (on
fake tensors for the dry run, or on real ones) and it logs every aten
and c10d op the step dispatches on one rank, and follows the step's
device memory.  :func:`op_stats` turns the log into the reference's keys:

* ``dot_flops_per_device`` — ``torch.utils.flop_counter``'s formula for
  each op it has one for (``mm``, ``bmm``, ``addmm``, ``baddbmm``, the
  convolutions and attention kernels), plus ``2·M·N·K`` for
  ``_int_mm``; split by the product's dtype in ``dot_flops_by_dtype``
  (the roofline's compute term takes each at its own peak).  The counter
  dispatches as ``FlopCounterMode`` does (each op first offered to its
  ``decompose``), so the count equals ``FlopCounterMode``'s on the same
  step;
* ``elem_flops_per_device`` — the output elements of the pointwise ops
  (``torch.Tag.pointwise``), as ``hlo.py`` counts its elementwise ops;
* ``hbm_bytes_per_device`` — each op's input bytes plus output bytes on
  the step's device.  This is the eager port's real traffic, not an
  upper bound as it would be for a compiled program: every aten op
  launches its own kernels, with no fusion across ops, so each reads its
  operands from HBM and writes its results back.  Views (``view``,
  ``t``, ``expand``, ``slice``, ``_unsafe_view``…) move nothing and count
  nothing.  An
  in-place update counts the bytes it writes, and its target's read only
  where the op reads it (``add_`` does, ``copy_`` and ``fill_`` do not).
  An operand passed twice is read once;
* ``collective_bytes_per_device``, ``collective_bytes_by_kind`` and
  ``collective_counts`` — from the c10d ops (and the functional
  collectives) by kind, with ``hlo.py``'s payload rule (an all-gather's
  output, the larger of input and output otherwise) and ring factors
  (all-reduce ×2, the others ×1).

What the counter cannot see: work that is not an aten op (a ``ctypes``
launch of a hand-written kernel — the dry run reaches none), and the L2
cache, which serves a small operand's re-read without HBM traffic.

The log (:meth:`OpCounter.log`) holds, for each distinct op signature, its
count, bytes, pointwise elements, collective payload and, for a product,
its shape-mapped arguments, so :func:`op_stats` re-derives every number
from the log alone (``repro_torch.launch.reanalyze``).
"""

from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

COLL_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
               "all-to-all": 1.0, "collective-permute": 1.0}

# c10d op name (``torch.ops.c10d.*`` or ``_c10d_functional.*``) → kind
_COLL_KIND = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast_": "collective-permute",
}
# c10d ops that read the tensors they write (the others only write arg 0)
_COLL_READ_WRITE = {"allreduce_", "allreduce_coalesced_", "broadcast_"}

# ops without an alias annotation that still move no data: a view of a
# fresh result (``matmul``'s reshapes), a constant lifted into the graph
_FREE = {"_unsafe_view", "lift_fresh", "_reshape_alias"}

# in-place ops that write their target without reading it
_WRITE_ONLY = {"copy_", "fill_", "zero_", "normal_", "uniform_", "random_",
               "bernoulli_", "exponential_", "index_put_", "set_",
               "resize_"}

# metadata queries FlopCounterMode hands back (NotImplemented): neither
# ops nor traffic
_META_QUERIES = {
    torch.ops.aten.sym_is_contiguous.default,
    torch.ops.aten.is_contiguous.default,
    torch.ops.aten.is_contiguous.memory_format,
    torch.ops.aten.is_strides_like_format.default,
    torch.ops.aten.is_non_overlapping_and_dense.default,
    torch.ops.aten.size.default, torch.ops.aten.sym_size.default,
    torch.ops.aten.stride.default, torch.ops.aten.sym_stride.default,
    torch.ops.aten.storage_offset.default,
    torch.ops.aten.sym_storage_offset.default,
    torch.ops.aten.numel.default, torch.ops.aten.sym_numel.default,
    torch.ops.aten.dim.default, torch.ops.prim.layout.default}

_DTYPE_CLASS = {torch.bfloat16: "bf16", torch.float16: "f16",
                torch.float32: "f32", torch.float64: "f32"}

# the CUDA caching allocator hands out blocks in multiples of 512 bytes
ALLOC_ROUND = 512


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree, out=None) -> list:
    """The tensors of a nest of lists, tuples and dicts, in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _shape_arg(a):
    """An argument as the log keeps it: a tensor as its shape and dtype,
    a device or dtype as its name, numbers, strings and lists as they
    are."""
    if isinstance(a, torch.Tensor):
        return {"shape": list(a.shape), "dtype": str(a.dtype)[6:]}
    if isinstance(a, (torch.device, torch.dtype, torch.memory_format,
                      torch.layout)):
        return str(a)
    if isinstance(a, (bool, int, float, str)) or a is None:
        return a
    if isinstance(a, (list, tuple)):
        return [_shape_arg(x) for x in a]
    return repr(a)


def _shapes(a):
    """A logged argument back as what the flop formulas read: a tensor's
    ``torch.Size``."""
    if isinstance(a, dict) and "shape" in a:
        return torch.Size(a["shape"])
    if isinstance(a, list):
        return [_shapes(x) for x in a]
    return a


def _packet(name: str):
    """``aten.mm.default`` → the op packet ``torch.ops.aten.mm``."""
    ns, op = name.split(".")[:2]
    return getattr(getattr(torch.ops, ns), op)


def dot_flops(rec: dict) -> float:
    """A logged product's FLOPs: ``torch.utils.flop_counter``'s formula
    on its shapes, or ``2·M·N·K`` for ``_int_mm``."""
    if rec["op"].startswith("aten._int_mm"):
        (m, k), (_, n) = rec["args"][0]["shape"], rec["args"][1]["shape"]
        return 2.0 * m * n * k
    fn = flop_registry[_packet(rec["op"])]
    out = _shapes(rec["out"])
    return float(fn(*_shapes(rec["args"]),
                    **{k: _shapes(v) for k, v in rec["kwargs"].items()},
                    out_val=out[0] if len(out) == 1 else tuple(out)))


def _is_dot(func) -> bool:
    return (func._overloadpacket in flop_registry
            or func._overloadpacket is torch.ops.aten._int_mm)


class OpCounter(TorchDispatchMode):
    """Log the ops of one rank's step and follow its device memory.

    ``device``: the step's device (bytes and memory count only tensors on
    it; host tensors are the host's).  :meth:`track` registers tensors
    that exist before the step (its arguments) as live memory; every
    storage an op creates on the device is live from then until Python
    frees it, rounded up to ``ALLOC_ROUND`` bytes as the CUDA caching
    allocator rounds it.  ``peak_bytes`` is the most that was live at
    once, arguments included."""

    def __init__(self, device) -> None:
        super().__init__()
        self.device = torch.device(device)
        self._log: dict = {}        # signature → [record, count]
        self._live = WeakIdKeyDictionary()
        self.live_bytes = 0
        self.peak_bytes = 0
        self.decomposed = 0

    # -- memory --------------------------------------------------------------

    def _on_device(self, t: torch.Tensor) -> bool:
        dev = t.device
        return dev.type == self.device.type and \
            (self.device.index is None or dev.index in (None,
                                                        self.device.index))

    def _free(self, size: int) -> None:
        self.live_bytes -= size

    def _hold(self, t: torch.Tensor) -> None:
        if not self._on_device(t):
            return
        st = t.untyped_storage()
        if st in self._live:
            return
        size = -(-st.nbytes() // ALLOC_ROUND) * ALLOC_ROUND
        ref = weakref.ref(st, lambda _, size=size: self._free(size))
        self._live[st] = (size, ref)
        self.live_bytes += size
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def track(self, tree) -> int:
        """Hold every tensor of ``tree`` (DTensors by their local block)
        as live; returns the bytes they add."""
        before = self.live_bytes
        for t in _tensors(tree):
            self._hold(getattr(t, "_local_tensor", t))
        return self.live_bytes - before

    # -- dispatch ------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _META_QUERIES:
            return NotImplemented
        if func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                self.decomposed += 1
                return r
        out = func(*args, **kwargs)
        self._record(func, args, kwargs, out)
        for t in _tensors(out):
            self._hold(t)
        return out

    def _bytes(self, ts) -> int:
        seen, total = set(), 0
        for t in ts:
            if id(t) not in seen and self._on_device(t):
                seen.add(id(t))
                total += _nbytes(t)
        return total

    def _record(self, func, args, kwargs, out) -> None:
        name = str(func)
        ns, op = name.split(".")[:2]
        rec = {"op": name}
        if ns in ("c10d", "_c10d_functional"):
            kind = _COLL_KIND.get(op, op)
            if ns == "c10d":
                written = _tensors(args[0])
                read = _tensors(args[1:]) + (written if op in
                                             _COLL_READ_WRITE else [])
            else:
                written, read = _tensors(out), _tensors((args, kwargs))
            out_b, in_b = self._bytes(written), self._bytes(read)
            payload = out_b if kind == "all-gather" else max(out_b, in_b)
            rec.update(kind="collective", coll=kind, payload=payload,
                       reads=in_b, writes=out_b)
        elif func.is_view:
            rec.update(kind="view")
        else:
            schema = func._schema
            mutated = []
            for i, a in enumerate(schema.arguments):
                if a.alias_info is not None and a.alias_info.is_write:
                    v = args[i] if i < len(args) else kwargs.get(a.name)
                    mutated += _tensors(v)
            ids = {id(t) for t in mutated}
            read = [t for t in _tensors((args, kwargs)) if id(t) not in ids]
            if mutated:
                writes = self._bytes(mutated)
                if op not in _WRITE_ONLY:
                    read += mutated
            else:
                writes = self._bytes(_tensors(out))
            outs = [t for t in _tensors(out) if self._on_device(t)]
            on_dev = bool(outs) or any(self._on_device(t) for t in mutated)
            rec.update(kind="op" if on_dev else "host",
                       reads=self._bytes(read), writes=writes)
            if on_dev and torch.Tag.pointwise in func.tags:
                rec["elems"] = sum(t.numel() for t in (outs or mutated))
            if on_dev and _is_dot(func):
                rec.update(args=_shape_arg(list(args)),
                           kwargs={k: _shape_arg(v)
                                   for k, v in kwargs.items()},
                           out=[_shape_arg(t) for t in _tensors(out)],
                           dtype=("int8" if op == "_int_mm" else
                                  _DTYPE_CLASS.get(outs[0].dtype, "f32")))
        key = tuple(v if isinstance(v, (str, int, float)) else repr(v)
                    for v in rec.values())
        entry = self._log.get(key)
        if entry is None:
            self._log[key] = [rec, 1]
        else:
            entry[1] += 1

    def log(self) -> list:
        """The distinct op records, each with its ``count``."""
        return [dict(rec, count=n) for rec, n in self._log.values()]


def op_stats(log: list) -> dict:
    """The reference's per-device keys (and a few of the port's own) from
    an :class:`OpCounter` log."""
    dot = elem = hbm = 0.0
    by_dtype: dict = {}
    coll: dict = {}
    counts: dict = {}
    n_ops = n_views = 0
    for rec in log:
        n = rec["count"]
        if rec["kind"] == "view" or rec["op"].split(".")[1] in _FREE:
            n_views += n
            continue
        if rec["kind"] == "host":
            continue
        n_ops += n
        hbm += n * (rec["reads"] + rec["writes"])
        elem += n * rec.get("elems", 0)
        if "args" in rec:
            f = n * dot_flops(rec)
            dot += f
            by_dtype[rec["dtype"]] = by_dtype.get(rec["dtype"], 0.0) + f
        if rec["kind"] == "collective":
            kind = rec["coll"]
            coll[kind] = coll.get(kind, 0.0) + \
                n * rec["payload"] * COLL_FACTOR.get(kind, 1.0)
            counts[kind] = counts.get(kind, 0) + n
    return {
        "dot_flops_per_device": dot,
        "elem_flops_per_device": elem,
        "collective_bytes_per_device": sum(coll.values()),
        "collective_bytes_by_kind": coll,
        "collective_counts": counts,
        "hbm_bytes_per_device": hbm,
        "dot_flops_by_dtype": by_dtype,
        "device_ops": n_ops,
        "view_ops": n_views,
    }


