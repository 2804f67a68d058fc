"""An op-level account of one eager step: FLOPs by dtype, the bytes that
cross op boundaries, kernel launches, peak live bytes and the largest
buffers, the counterpart of the JAX package's compiled-HLO analysis
(src/repro/launch/hlo_stats.py:236 ``analyze_hlo``).

The port runs eagerly, so every aten op materialises its result and the
op boundary plays the role of XLA's fusion boundary.  ``OpCounter`` is a
``TorchDispatchMode``: under it, a step on the meta device is counted
without running (the dry-run's account), and the same step on a card is
counted as it runs.  Ops with a CompositeImplicitAutograd decomposition
(matmul, einsum, reshape, linear, ...) are decomposed first, as they are
when they run, so the counted ops are the ones that launch.

- FLOPs: ``torch.utils.flop_counter``'s formulas (matmuls, convolutions,
  attention), keyed by the dtype of the op's first input: float32
  matmuls run in strict fp32 on the card, bf16 on the tensor cores.
- Bytes: each op that writes memory reads its tensor inputs and writes
  its outputs once.  Views move nothing; an input that is a view reads
  only the elements it addresses (a slice its slice, a broadcast its
  base), as the reference's model reads only a dynamic-slice; a gather
  (indexing, embedding) reads its output's worth and its indices; an op
  that writes into its argument writes that argument, and reads it too
  unless it overwrites it (``copy_``, ``fill_``, ``zero_``); a scatter
  into an argument moves its update region and its indices.
- Launches: ops that launch device work.  Views, metadata and allocation
  without a fill (``empty``) launch nothing, nor does an op whose
  outputs are empty.
- Live bytes: each storage an op allocates counts from its first output
  until its Python storage object dies (``weakref.finalize``; a storage
  that autograd saves lives until backward releases it).  ``peak`` is
  the most live at once above what existed when the window opened.

``device_type`` restricts the account to ops that touch that device
(host-side scalars of the optimizer and the schedule are not the card's
work); None counts every op.
"""
from __future__ import annotations

import heapq
import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

TOP_BUFFERS = 12             # the largest outputs a counter keeps

# ops that allocate or describe without launching device work
_NO_KERNEL = {
    aten.empty.memory_format, aten.empty_strided.default,
    aten.new_empty.default, aten.new_empty_strided.default,
    aten.empty_like.default, aten._local_scalar_dense.default,
    aten.sym_size.int, aten.sym_stride.int, aten.sym_numel.default,
    aten.sym_storage_offset.default, aten.is_contiguous.default,
    aten.is_same_size.default, aten.is_nonzero.default,
    aten.set_.source_Storage, aten.set_.source_Storage_storage_offset,
    aten.resize_.default, aten.record_stream.default,
}
# ops whose written argument is overwritten, not read
_OVERWRITE = {aten.copy_.default, aten.fill_.Scalar, aten.fill_.Tensor,
              aten.zero_.default, aten.uniform_.default,
              aten.normal_.default, aten.random_.default}
# gathers: read as much of the source as they write, plus the indices
_GATHER = {aten.index.Tensor, aten.embedding.default, aten.gather.default,
           aten.index_select.default}
# scatters into an argument: move the update region and the indices
_SCATTER = {aten.index_put_.default, aten.index_put.default,
            aten._index_put_impl_.default, aten.scatter_.src,
            aten.scatter_.value, aten.scatter_add_.default,
            aten.scatter.src, aten.scatter.value, aten.scatter_add.default,
            aten.index_add_.default, aten.index_add.default,
            aten.index_copy_.default, aten.index_copy.default}


def addressed_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements a tensor addresses: a broadcast (stride 0)
    dim reads its base once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _written_args(func, args, kwargs) -> list:
    """The tensor arguments func writes into (its schema's ``a!``)."""
    out = []
    for i, arg in enumerate(func._schema.arguments):
        if arg.alias_info is None or not arg.alias_info.is_write:
            continue
        val = args[i] if i < len(args) else kwargs.get(arg.name)
        out += _tensors(val)
    return out


def _scatter_bytes(func, args, kwargs, target) -> int:
    """A scatter's update region: its values (or source) read and written
    and its indices read; a scalar value writes one element per index."""
    upd = idx = 0
    for i, arg in enumerate(func._schema.arguments):
        val = args[i] if i < len(args) else kwargs.get(arg.name)
        ts = _tensors(val)
        if arg.name in ("index", "indices"):
            idx += sum(map(addressed_bytes, ts))
            if not any(a.name in ("src", "values", "source")
                       for a in func._schema.arguments):
                upd += sum(t.numel() for t in ts) * target.element_size()
        elif arg.name in ("src", "values", "source"):
            upd += sum(map(addressed_bytes, ts))
    return 2 * upd + idx


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched inside ``with OpCounter(...)``: see the
    module docstring.  Read ``flops_by_dtype`` (dtype name -> FLOPs),
    ``flops``, ``eager_bytes``, ``launches``, ``ops``, ``peak_bytes``,
    ``live_bytes`` and ``top_buffers()``."""

    def __init__(self, device_type: str | None = None):
        super().__init__()
        self.device_type = device_type
        self.flops_by_dtype: Counter = Counter()
        self.eager_bytes = 0
        self.launches = 0
        self.ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict[int, int] = {}
        self._buffers: list = []
        self._n = 0

    @property
    def flops(self) -> int:
        return sum(self.flops_by_dtype.values())

    def top_buffers(self) -> list[dict]:
        """The largest outputs, largest first: {"bytes", "op", "shape",
        "dtype"}."""
        return [b for _, _, b in sorted(self._buffers, reverse=True)]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        with self:
            r = func.decompose(*args, **kwargs)
        if r is not NotImplemented:
            return r
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if self.device_type is not None and not any(
                t.device.type == self.device_type for t in ins + outs):
            return
        self.ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops_by_dtype[str(ins[0].dtype).replace("torch.", "")] += \
                int(flops)
        if func.is_view or func in _NO_KERNEL:
            if not func.is_view:
                self._track(func, outs)
            return
        written = _written_args(func, args, kwargs)
        if not any(t.numel() for t in (written or outs)):
            return
        self.launches += 1
        if func in _SCATTER:
            moved = _scatter_bytes(func, args, kwargs, ins[0])
        elif written:
            ids = {id(t) for t in written}
            reads = [t for t in ins if id(t) not in ids]
            if func not in _OVERWRITE:
                reads += written
            moved = sum(map(addressed_bytes, reads + written))
        elif func in _GATHER:
            idx = [t for t in ins[1:] if not t.is_floating_point()]
            moved = 2 * sum(map(addressed_bytes, outs)) + sum(
                map(addressed_bytes, idx))
        else:
            moved = sum(map(addressed_bytes, ins + outs))
        self.eager_bytes += moved
        if not written:
            self._track(func, outs)

    def _track(self, func, outs) -> None:
        for t in outs:
            storage = t.untyped_storage()
            key = storage._cdata
            if key in self._live:
                continue
            nbytes = storage.nbytes()
            self._live[key] = nbytes
            self.live_bytes += nbytes
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(storage, self._free, key)
            self._n += 1
            entry = (nbytes, self._n, {
                "bytes": nbytes, "op": str(func), "shape": list(t.shape),
                "dtype": str(t.dtype).replace("torch.", "")})
            if len(self._buffers) < TOP_BUFFERS:
                heapq.heappush(self._buffers, entry)
            elif nbytes > self._buffers[0][0]:
                heapq.heapreplace(self._buffers, entry)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)
