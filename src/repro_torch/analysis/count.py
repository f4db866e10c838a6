"""Per-device work of one call, counted from the ops it runs (the port's
counterpart of ``repro/analysis/hlo.py``).

The JAX package parses a compiled step's HLO. The port has none, so
``Count`` (a ``TorchDispatchMode``) counts the aten ops of one call as
they run, on any device, ``meta`` included, and returns what
``analyze_hlo`` returns:

    {"collectives": {kind: {operand_bytes, result_bytes, count}},
     "dot_flops": float, "traffic_bytes": float}

* **Per device.** The JAX package counts the partitioned module: one
  device's work. Here that is rank 0's local work. A mode sees a DTensor
  op at its global shapes, and while its handler runs the mode is off,
  so the local ops DTensor runs would go unseen. ``Count`` therefore
  counts nothing at the DTensor level: it returns ``NotImplemented``
  there, so DTensor dispatches with the mode still on, and the mode sees
  the local ops on the shards (replicated computation included) and the
  ``_c10d_functional`` collectives of the redistributions. The ops
  DTensor runs on fake tensors to propagate shapes are not counted.
* **No loop weighting.** Eager PyTorch unrolls every layer and
  microbatch, so each is counted as it runs (the JAX package scans its
  layers and multiplies the body by the trip count).
* **dot_flops**: 2·M·N·K over every matrix product (mm, addmm, bmm,
  baddbmm, mv, dot; einsum and matmul as they lower to these). No
  convolution, as in the JAX package.
* **traffic_bytes**: the JAX package's rule, 2 x the bytes written by
  real-work ops (each byte written was read about once upstream):
  products and convolutions, copies, cat, gathers and scatters, index
  puts, reductions (softmax and the norms among them), sorts and
  collectives. Views and elementwise ops do not count. An in-place
  update (``copy_`` into a slice, ``index_put_``, ``index_copy_``, an
  in-place scatter) counts the bytes it writes, not its whole target.
  On the card eager elementwise ops do move bytes, so this is a
  fusion-optimistic lower bound there too.
* **Kernel calls.** A hand-written kernel is opaque to an aten-level
  count. So each dispatcher of ``kernels/ops.py`` adds its kernel's
  work by formula (``ops.WORK``: what this count gives the kernel's
  plain version) and runs its call uncounted (``Count.kernel``): the
  count is the same on the CPU, the card and ``meta``.
* **By op** (``Count(by_op=True)``, a diagnostic, off by default: a
  cell's with ``launch.dryrun.run_cell(..., by_op=True)``): the dot
  flops also summed by op and operand shapes (a kernel call by its
  name), largest first, under ``dot_flops_by_op`` in the result: where
  a cell's count comes from.
* **Collectives**: the functional collectives DTensor calls, the
  ProcessGroup ops (``c10d``) of ``torch.distributed`` calls, and
  DTensor's all-to-all, by the JAX package's kinds. Operand bytes are
  the input's, result bytes the output's. A send is one
  ``collective-permute`` (its operand), a receive adds its result.

``Live`` (a sibling mode, entered with ``Count`` or alone) keeps the
memory record that ``memory_analysis`` gives the JAX package: rank 0's
peak live local bytes over one call, and its largest single
allocation.

* **Allocations.** Every op output that owns storage not seen before
  adds its storage's bytes when it is made; a view, an in-place op or an
  ``out=`` write lands in storage already counted (or in an argument's)
  and adds nothing. Each storage is counted once.
* **Frees.** A storage's bytes come off when the storage itself dies (a
  finalizer on it), not when a Python name goes: a tensor autograd
  saves for the backward stays live until the backward releases it.
* **What is not counted.** DTensor-level ops (as ``Count``: their local
  ops are what run); any output that is not a plain tensor: the fake
  tensors of DTensor's sharding propagation (checked on each output, as
  its factory ops take no tensor) and the functional collectives'
  ``AsyncCollectiveTensor``, which wraps a result already counted; and
  anything allocated before the mode was entered: the call's arguments
  are not in the peak, its outputs are (they are made inside it). The
  running total starts at 0.
* **The peak** is the running total's maximum; ``largest`` the single
  largest storage made, with the shape and dtype of the output that
  made it and its op. Bytes are the storage's own, so a ``meta`` tensor
  counts what it would hold on the card; allocator rounding and caching
  are not modelled.

Usage::

    with Count() as c, Live() as m:
        step(*args)
    c.result(), m.result()
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

# bytes per element by the HLO type names of the JAX package's table
_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}
HLO_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.float8_e4m3fn: "f8e4m3fn", torch.float8_e5m2: "f8e5m2",
    torch.int16: "s16", torch.uint16: "u16", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.int32: "s32", torch.uint32: "u32",
    torch.float32: "f32", torch.int64: "s64", torch.uint64: "u64",
    torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128",
}


def dtype_bytes(dtype: torch.dtype) -> int:
    return _DTYPE_BYTES[HLO_NAMES[dtype]]


def tensor_bytes(t) -> int:
    """Bytes of a tensor, or of every tensor in a (nested) list or tuple."""
    if isinstance(t, (list, tuple)):
        return sum(tensor_bytes(x) for x in t)
    if not isinstance(t, torch.Tensor):
        return 0
    return t.numel() * dtype_bytes(t.dtype)


aten = torch.ops.aten
# the matrix products, by the position of their left operand
_DOTS = {aten.mm: 0, aten.bmm: 0, aten.mv: 0, aten.dot: 0,
         aten.addmm: 1, aten.baddbmm: 1, aten.addmv: 1}
# out-of-place real work: 2 x the bytes of every output
_WRITES = {
    aten.convolution, aten.convolution_backward,
    aten.clone, aten.copy, aten.cat, aten.stack,
    aten.gather, aten.index_select, aten.index, aten.embedding, aten.take,
    aten.scatter, aten.scatter_add, aten.index_put, aten.index_copy,
    aten.index_add, aten.masked_scatter, aten.embedding_dense_backward,
    aten.sum, aten.mean, aten.amax, aten.amin, aten.max, aten.min,
    aten.argmax, aten.argmin, aten.prod, aten.any, aten.all, aten.var,
    aten.std, aten.var_mean, aten.std_mean, aten.logsumexp,
    aten.linalg_vector_norm, aten.norm, aten.cumsum, aten.logcumsumexp,
    aten._softmax, aten._log_softmax, aten._softmax_backward_data,
    aten._log_softmax_backward_data, aten.nll_loss_forward,
    aten.nll_loss_backward, aten.native_layer_norm, aten.native_group_norm,
    aten.sort, aten.topk,
}
# the elementwise overloads of reductions' names (``torch.max(a, b)``)
_ELEMENTWISE = {aten.max.other, aten.min.other}
# in-place real work: 2 x the bytes written, the argument that holds them
# (a scatter of a value is a fill, elementwise: ``one_hot`` on the CPU
# and the card, where ``meta`` and the JAX package compare with an iota)
_UPDATES = {aten.copy_: 0, aten.index_put_: 2, aten.index_copy_: 3,
            aten.index_add_: 3, aten.scatter_: 3, aten.scatter_add_: 3,
            aten.masked_scatter_: 2}

# collective op -> (kind, operand argument, result argument or None for
# the return value); -1: no operand (a receive) or no result (a send)
_COLLECTIVE_OPS = {
    "_c10d_functional.all_gather_into_tensor": ("all-gather", 0, None),
    "_c10d_functional.all_gather_into_tensor_coalesced":
        ("all-gather", 0, None),
    "_c10d_functional.all_gather_into_tensor_out": ("all-gather", 0, None),
    "_c10d_functional.all_reduce": ("all-reduce", 0, None),
    "_c10d_functional.all_reduce_": ("all-reduce", 0, 0),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", 0, None),
    "_c10d_functional.all_reduce_coalesced_": ("all-reduce", 0, 0),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", 0, None),
    "_c10d_functional.reduce_scatter_tensor_coalesced":
        ("reduce-scatter", 0, None),
    "_c10d_functional.reduce_scatter_tensor_out":
        ("reduce-scatter", 0, None),
    "_c10d_functional.all_to_all_single": ("all-to-all", 0, None),
    "_dtensor.shard_dim_alltoall": ("all-to-all", 0, None),
    "c10d.allreduce_": ("all-reduce", 0, 0),
    "c10d.allreduce_coalesced_": ("all-reduce", 0, 0),
    "c10d._allgather_base_": ("all-gather", 1, 0),
    "c10d.allgather_": ("all-gather", 1, 0),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", 1, 0),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 1, 0),
    "c10d.reduce_scatter_": ("reduce-scatter", 1, 0),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1, 0),
    "c10d.alltoall_base_": ("all-to-all", 1, 0),
    "c10d.alltoall_": ("all-to-all", 1, 0),
    "c10d.send": ("collective-permute", 0, -1),
    "c10d.recv_": ("collective-permute", -1, 0),
}


def _is_fake(types) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return any(issubclass(t, FakeTensor) for t in types)


def _is_dtensor(types) -> bool:
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


class Count(TorchDispatchMode):
    """Counts the work of the ops run under it (see the module note)."""

    def __init__(self, by_op: bool = False):
        super().__init__()
        self.dot_flops = 0.0
        self.traffic_bytes = 0.0
        self.collectives: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {"operand_bytes": 0.0, "result_bytes": 0.0,
                     "count": 0.0})
        self.by_op = defaultdict(float) if by_op else None
        self._paused = 0

    @contextlib.contextmanager
    def kernel(self, flops: float, nbytes: float, name: str):
        """A kernel call (``name``): ``flops`` and ``nbytes`` added, the
        ops run inside not counted."""
        self.dot_flops += flops
        self.traffic_bytes += nbytes
        if self.by_op is not None:
            self.by_op[name] += flops
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _is_dtensor(types):
            return NotImplemented       # count DTensor's local ops instead
        out = func(*args, **kwargs)
        if not self._paused and not _is_fake(types):
            self._add(func, args, out)
        return out

    def _add(self, func, args, out) -> None:
        packet = func.overloadpacket
        if packet in _DOTS:
            lhs = args[_DOTS[packet]]
            flops = 2.0 * out.numel() * lhs.shape[-1]
            self.dot_flops += flops
            self.traffic_bytes += 2 * tensor_bytes(out)
            if self.by_op is not None:
                shapes = " x ".join(str(tuple(a.shape)) for a in args
                                    if isinstance(a, torch.Tensor))
                self.by_op[f"{packet.__name__} {shapes}"] += flops
        elif packet in _WRITES and func not in _ELEMENTWISE:
            self.traffic_bytes += 2 * tensor_bytes(out)
        elif packet in _UPDATES:
            self.traffic_bytes += 2 * tensor_bytes(args[_UPDATES[packet]])
        else:
            kind = _COLLECTIVE_OPS.get(func._schema.name.replace("::", "."))
            if kind is None:
                return
            kind, operand, result = kind
            t = self.collectives[kind]
            res = out if result is None else (
                args[result] if result >= 0 else None)
            if operand >= 0:
                t["operand_bytes"] += tensor_bytes(args[operand])
                t["count"] += 1
            t["result_bytes"] += tensor_bytes(res)
            self.traffic_bytes += 2 * tensor_bytes(res)

    def result(self) -> Dict[str, object]:
        out = {"collectives": {k: dict(v)
                               for k, v in self.collectives.items()},
               "dot_flops": self.dot_flops,
               "traffic_bytes": self.traffic_bytes}
        if self.by_op is not None:
            out["dot_flops_by_op"] = sorted(self.by_op.items(),
                                            key=lambda kv: -kv[1])
        return out


def _tensors(x):
    """The tensors of an op's (nested) arguments or outputs."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


# the tensor types whose storage is an allocation: not a wrapper subclass
# (DTensor, the fake tensors of sharding propagation, the functional
# collectives' AsyncCollectiveTensor)
_PLAIN = (torch.Tensor, torch.nn.Parameter)


class Live(TorchDispatchMode):
    """Peak live bytes of the storages made by the ops run under it, and
    the largest one (see the module note)."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.largest: Optional[Dict[str, object]] = None
        self._held: Dict[int, int] = {}     # id(storage) -> its bytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _is_dtensor(types):
            return NotImplemented       # the local ops are what allocate
        out = func(*args, **kwargs)
        self._add(func, args, kwargs, out)
        return out

    def _add(self, func, args, kwargs, out) -> None:
        inputs = None
        for t in _tensors(out):
            if type(t) not in _PLAIN:
                continue            # a wrapper subclass owns no storage
            st = t.untyped_storage()
            key = id(st)
            if key in self._held:
                continue
            if inputs is None:
                inputs = {id(a.untyped_storage())
                          for a in _tensors((args, kwargs))
                          if type(a) in _PLAIN}
            if key in inputs:           # a view or in-place write
                continue
            n = st.nbytes()
            self._held[key] = n
            weakref.finalize(st, self._free, key).atexit = False
            self.live += n
            self.peak = max(self.peak, self.live)
            if self.largest is None or n > self.largest["bytes"]:
                self.largest = {"bytes": n, "shape": list(t.shape),
                                "dtype": str(t.dtype).replace("torch.", ""),
                                "op": str(func.overloadpacket)}

    def _free(self, key: int) -> None:
        self.live -= self._held.pop(key, 0)

    def result(self) -> Dict[str, object]:
        return {"peak_bytes": self.peak, "largest": self.largest}


def active() -> Optional[Count]:
    """The innermost ``Count`` on this thread's dispatch-mode stack."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, Count):
            return mode
    return None


def count_call(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` under a ``Count``: (its result, the
    count's result)."""
    with Count() as c:
        out = fn(*args, **kwargs)
    return out, c.result()
