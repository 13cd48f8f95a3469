"""Op-level cost counter of a step (the port's counterpart of
``repro.analysis.hlo_parse``).

The JAX package reads FLOPs, bytes and collective bytes out of the
compiled HLO of a step, multiplying each ``while`` body by its trip
count.  The port has no HLO: what it runs is its stream of aten ops, so
the counter is a ``TorchDispatchMode`` that sees every op a step
executes, on real or fake tensors.  Python loops run every iteration,
so no trip count is needed.  The reference's rules are kept:

* **FLOPs** are those of the products only: 2 × numel(out) × K for the
  matrix products, the window product for convolutions (the formulas of
  ``torch.utils.flop_counter``).
* **bytes** of an op are its result bytes plus its operand bytes.  Views
  and metadata ops cost nothing (``ZERO_COST``: ``view``, ``t``,
  ``permute``, ``expand``, slices as views, ``detach``, the ``empty*``
  factories, ...).  A gather or an index read is charged 2× its result; a
  copy into a buffer (a slice write) 2× what it writes; a scatter or
  ``index_put`` 3× its update.
* **collectives**: ``parallel.sharding``'s wrappers add each call's
  operand bytes per device under the reference's kinds (``all-reduce``,
  ``all-gather``, ``reduce-scatter``), and 2× those bytes to ``bytes``.
  The reference also keeps ``collectives_raw``, the payload before it
  halves XLA:CPU's float32 promotion of 16-bit all-reduces; nothing
  promotes here, so the field is not kept.

**Kernel entries count the same on every route.**  Each hand-written
kernel's entry (``grid_argmin``, ``flash_attention``'s forward and
backward, ``selective_scan``'s forward and backward) reports its own work
through :func:`kernel` (products, bytes read once and written once,
exponentials) and no op inside it is counted, neither the plain
version's (the CPU) nor the kernel route's own set-up (the card).  A
ctypes launch is invisible to a dispatch mode, so this is what makes a
step count the same on the card, on the CPU and on fake tensors.  On a
fake tensor an entry reports its work and returns empty outputs without
running anything (:func:`is_fake`).

The counter also follows the bytes of live tensors: each storage an op
creates is added when it appears and taken off when it is freed, so the
peak of a step run under the counter (on fake tensors, the dry run) is
the most its tensors held at once.  Tensors made before the counter
started are added with :meth:`OpCounter.hold`.

Usage::

    with op_cost.OpCounter() as c:
        out = step(params, opt_state, batch)
    c.cost.flops, c.cost.bytes, c.cost.collectives, c.peak_bytes
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Any, Callable, Dict, Iterator, List, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

aten = torch.ops.aten

#: Ops that move no data: metadata, the ``empty*`` factories, detach and
#: alias (views are recognised by their schema, ``OpOverload.is_view``).
ZERO_COST = {aten.detach, aten.alias, aten.lift_fresh, aten.empty, aten.empty_like,
             aten.empty_strided, aten.new_empty, aten.new_empty_strided,
             aten._local_scalar_dense, aten.sym_size, aten.sym_stride, aten.sym_numel,
             aten.sym_storage_offset, aten.is_same_size, aten.record_stream, aten.set_,
             aten.resize_, aten._unsafe_view}
#: Metadata queries, never decomposed (as ``torch.utils.flop_counter``).
_METADATA = {aten.sym_is_contiguous.default, aten.is_contiguous.default,
             aten.is_contiguous.memory_format, aten.is_strides_like_format.default,
             aten.is_non_overlapping_and_dense.default, aten.size.default,
             aten.sym_size.default, aten.stride.default, aten.sym_stride.default,
             aten.storage_offset.default, aten.sym_storage_offset.default, aten.numel.default,
             aten.sym_numel.default, aten.dim.default, torch.ops.prim.layout.default,
             torch.ops.prim.device.default}
#: Index reads: charged 2× their result (read what is picked, write it).
GATHERS = {aten.index, aten.gather, aten.index_select, aten.embedding,
           aten.embedding_dense_backward, aten.take}
#: Scatters: 3× the update (read it, read and write the target's slice),
#: with the update's argument position.
SCATTERS = {aten.scatter: 3, aten.scatter_: 3, aten.scatter_add: 3, aten.scatter_add_: 3,
            aten.scatter_reduce: 3, aten.scatter_reduce_: 3, aten.index_put: 2,
            aten.index_put_: 2, aten._index_put_impl_: 2, aten.index_add: 3,
            aten.index_add_: 3, aten.index_copy: 3, aten.index_copy_: 3}
#: Writes into a buffer: 2× what they write (the update's bytes), as the
#: reference charges a dynamic-update-slice; the update's position.
SLICE_WRITES = {aten.copy_: 1, aten.slice_scatter: 1, aten.select_scatter: 1,
                aten.masked_scatter_: 2}
#: Elementwise transcendentals: one a result element.
TRANSCENDENTAL = {aten.exp, aten.exp_, aten.exp2, aten.expm1, aten.log, aten.log_,
                  aten.log1p, aten.log2, aten.tanh, aten.tanh_, aten.sigmoid,
                  aten.rsqrt, aten.sqrt, aten.sin, aten.cos, aten.erf,
                  aten.softplus, aten.silu, aten.gelu, aten._softmax, aten._log_softmax,
                  aten.logsumexp}


def is_fake(t: Any) -> bool:
    """Whether ``t`` is a fake tensor (the dry run's): a kernel entry then
    reports its work and returns empty outputs, and no real tensor ever
    takes that route."""
    return isinstance(t, FakeTensor)


def tensor_bytes(*tensors: Any) -> float:
    """Bytes of the given tensors (None skipped): numel × item size."""
    return float(sum(t.numel() * t.element_size() for t in tensors if t is not None))


@dataclasses.dataclass
class OpCost:
    """The reference's ``HloCost``: totals per device, and the same totals
    by op (``by_op``) and by name (``flops_by_name``, ``bytes_by_name``:
    the innermost ``record_function`` range and the op, or the kernel)."""

    flops: float = 0.0
    bytes: float = 0.0
    transcendentals: float = 0.0
    collectives: Dict[str, float] = dataclasses.field(default_factory=dict)
    by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    flops_by_name: Dict[str, float] = dataclasses.field(default_factory=dict)
    bytes_by_name: Dict[str, float] = dataclasses.field(default_factory=dict)

    def coll_total(self) -> float:
        return sum(self.collectives.values())

    def add_collective(self, kind: str, b: float):
        self.collectives[kind] = self.collectives.get(kind, 0.0) + b

    def collective_bytes(self) -> Dict[str, float]:
        """Per-device collective bytes by kind, with their ``total``."""
        out = dict(self.collectives)
        out["total"] = self.coll_total()
        return out

    def charge(self, op: str, name: str, flops: float, b: float, tr: float = 0.0):
        self.flops += flops
        self.bytes += b
        self.transcendentals += tr
        self.by_op[op] = self.by_op.get(op, 0.0) + b
        self.bytes_by_name[name] = self.bytes_by_name.get(name, 0.0) + b
        if flops:
            self.flops_by_name[name] = self.flops_by_name.get(name, 0.0) + flops


#: The running counters, innermost last; a module-level list, not a
#: thread-local one, since autograd runs a CUDA backward on its own thread.
_ACTIVE: List["OpCounter"] = []
#: Depth of kernel entries now running (their ops are not counted).
_IN_KERNEL = [0]


@contextlib.contextmanager
def kernel(name: str, work: Callable[[], Tuple[float, float, float]]) -> Iterator[None]:
    """The body of a kernel entry: ``work()`` gives its ``(flops, bytes,
    transcendentals)``, charged once to every running counter under
    ``name`` (it is called only when one runs), and no op inside the body
    is counted."""
    if _ACTIVE:
        flops, b, tr = work()
        for c in _ACTIVE:
            c.cost.charge(name, name, flops, b, tr)
    _IN_KERNEL[0] += 1
    try:
        yield
    finally:
        _IN_KERNEL[0] -= 1


def add_collective(kind: str, x: torch.Tensor) -> None:
    """A collective of ``kind`` on operand ``x``: its bytes per device to
    every running counter, and 2× them to ``bytes``."""
    if not _ACTIVE:
        return
    b = tensor_bytes(x)
    for c in _ACTIVE:
        c.cost.add_collective(kind, b)
        c.cost.charge(kind, "coll:" + kind, 0.0, 2.0 * b)


def _charge_bytes(packet, args, kwargs, out) -> float:
    if packet in GATHERS:
        return 2.0 * tensor_bytes(*_tensors(out))
    if packet in SCATTERS or packet in SLICE_WRITES:
        pos = SCATTERS.get(packet) or SLICE_WRITES[packet]
        upd = args[pos] if len(args) > pos else next(iter(kwargs.values()), None)
        if packet is aten.copy_:       # what is written is the destination's extent
            upd = args[0]
        k = 3.0 if packet in SCATTERS else 2.0
        return k * tensor_bytes(*_tensors(upd))
    return tensor_bytes(*_tensors(out)) + tensor_bytes(*_tensors((args, kwargs)))


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class OpCounter(TorchDispatchMode):
    """Counts the ops of what runs under it into ``cost`` (an
    :class:`OpCost`) and follows live tensor bytes: ``live_bytes`` now,
    ``peak_bytes`` at most."""

    def __init__(self):
        super().__init__()
        self.cost = OpCost()
        self.live_bytes = 0.0
        self.peak_bytes = 0.0
        self._seen = WeakIdKeyDictionary()
        self._ranges: List[str] = []

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def _free(self, n: float):
        self.live_bytes -= n

    def hold(self, tree: Any) -> None:
        """Add the storages of every tensor in ``tree`` (made before the
        counter started) to the live bytes."""
        for t in _tensors(tree):
            self._track(t)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _track(self, t: torch.Tensor):
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = float(st.nbytes())
        self._seen[st] = n
        self.live_bytes += n
        weakref.finalize(st, self._free, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in _METADATA:
            # a composite op (under inference_mode matmul and einsum reach the
            # mode whole): count the ops it is made of, as autograd would show them
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        packet = func._overloadpacket
        if packet is torch.ops.profiler._record_function_enter_new:
            self._ranges.append(args[0])
        elif packet is torch.ops.profiler._record_function_exit and self._ranges:
            self._ranges.pop()
        out = func(*args, **kwargs)
        for t in _tensors(out):
            self._track(t)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        if (_IN_KERNEL[0] or func.is_view or packet in ZERO_COST or func in _METADATA
                or func.namespace in ("profiler", "c10d", "_c10d_functional")):
            return out
        op = str(packet).split(".", 1)[-1]
        name = f"{self._ranges[-1]}/{op}" if self._ranges else op
        flops = float(flop_registry[packet](*args, **kwargs, out_val=out)
                      if packet in flop_registry else 0.0)
        tr = float(sum(t.numel() for t in _tensors(out))) if packet in TRANSCENDENTAL else 0.0
        self.cost.charge(op, name, flops, _charge_bytes(packet, args, kwargs, out), tr)
        return out


def analyze(fn: Callable, *args, **kwargs) -> OpCost:
    """The :class:`OpCost` of one call ``fn(*args, **kwargs)``, the
    counterpart of ``analyze_hlo`` on the call's compiled program."""
    with OpCounter() as c:
        fn(*args, **kwargs)
    return c.cost


def collective_bytes(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """Per-device collective bytes by kind of one call, with ``total``."""
    return analyze(fn, *args, **kwargs).collective_bytes()
