"""The dry-run's analyses of a traced step: flops and bytes, the
collectives, the ops, live memory, and the roofline terms (port of
``repro.launch.jaxpr_cost``, ``hlo_analysis`` and ``hlo_graph``).

The reference lowers a step and reads two programs: the jaxpr (flops and a
model of HBM bytes, scan bodies times their trip counts) and the compiled
HLO (collective bytes, the op census, XLA's memory analysis).  The port has
no compiler between it and the card: ``trace`` runs the step once, eagerly,
on fake tensors (``FakeTensorMode``; under a ``DeviceMesh`` over the
``"fake"`` process group for a sharded step), inside a
``TorchDispatchMode`` that sees every aten op one rank runs, DTensor's
redistributions as the c10d functional collectives they issue on that
rank's local tensors.  An eager trace runs every loop iteration, so every
count is trip-aware by construction (what ``hlo_graph`` exists to
recover).  Numbers are the traced rank's: per device.

- flops: products exact (``torch.utils.flop_counter``'s formulas for mm,
  bmm, convolutions), 1 flop an output element for every other op but
  views, copies and allocations, plus each kernel op's own count
  (``kernels/cost.py``: a kernel op on fake tensors launches nothing and
  charges its cost); the kernels' products and the aten products are the
  dot flops;
- bytes: the reference's "materialization points" model carried over to
  aten ops: gathers, index and scatter ops, cat and stack, sorts and
  top-k, reductions and cumulative sums count their operands and results,
  products too; views, elementwise ops and casts count nothing (fused);
  each top-level argument and output counts once; a kernel op counts the
  bytes it must move;
- collectives: the bytes each collective injects on this rank, which is
  its operand: all-reduce and all-to-all their input (= result),
  all-gather its input (= result / g), reduce-scatter its input (= result
  x g), the reference's conversions from an HLO result type;
- memory: the bytes of the live storages, arguments included, at their
  peak over the trace (a weakref on each storage the trace creates; fake
  tensors have sizes and no data).

DTensor's sharding propagation runs each new op once on fake tensors of
the global shapes to learn its output's; those ops are no rank's work, and
the counters skip them (``_quiet_propagation``).

What has no counterpart: the HLO text parsers (``parse_collective_line``,
``group_size``, ``split_computations``, ``while_census``) -- the
collectives come typed and per rank from the dispatch, and there is no
while loop to walk; ``cpu_upcast_bytes`` -- fake tensors keep bf16, there
is no CPU backend's f32 copy to subtract.

``roofline_terms`` reads the terms against an NVIDIA H100's peaks
(``kernels/cost.py``), never a TPU's.
"""

from __future__ import annotations

import time
import weakref
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Tuple

import torch
import torch.utils._pytree as pytree
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..kernels.cost import (DOT_KERNELS, HBM_BYTES_PER_S, LINK_BYTES_PER_S,
                            PEAK_FLOPS, Charges, charging)

# ops that move or make tensors without arithmetic: no flops, no bytes
FREE = {
    "view", "_unsafe_view", "reshape", "permute", "transpose", "t",
    "expand", "slice", "select", "squeeze", "unsqueeze", "unbind", "split",
    "split_with_sizes", "chunk", "narrow", "as_strided", "alias", "detach",
    "clone", "_to_copy", "copy", "copy_", "contiguous", "empty",
    "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "zeros", "zeros_like", "new_zeros", "ones", "ones_like", "new_ones",
    "full", "full_like", "new_full", "arange", "lift_fresh",
    "lift_fresh_copy", "fill_", "zero_", "fill", "diagonal", "unfold",
    "view_as", "_reshape_alias", "expand_as", "repeat",
    "where", "constant_pad_nd", "masked_fill", "masked_fill_", "flip",
    "slice_backward", "select_backward", "stack_backward", "device",
}

# ops whose operands and results reach memory (the reference's
# MATERIALIZING, in aten's names)
MATERIALIZING = {
    "gather", "index", "index_select", "index_put", "index_put_",
    "_index_put_impl_", "index_add", "index_add_", "index_copy",
    "index_copy_", "scatter", "scatter_", "scatter_add", "scatter_add_",
    "scatter_reduce", "scatter_reduce_", "embedding",
    "embedding_dense_backward", "slice_scatter", "select_scatter",
    "cat", "stack", "sort", "argsort", "topk", "cumsum", "cumprod",
    "logcumsumexp", "sum", "mean", "amax", "amin", "max", "min", "prod",
    "any", "all", "logsumexp", "argmax", "argmin", "var", "std",
    "linalg_vector_norm", "norm",
}

# c10d functional collectives -> the reference's kinds
COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "broadcast",
    "broadcast_": "broadcast",
}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    dot_flops: float = 0.0


@dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


@dataclass
class Trace:
    """What one traced run of a step did on the traced rank."""

    cost: Cost
    collectives: CollectiveStats
    ops: Dict[str, int]            # aten ops run, by name
    kernels: Charges               # kernel ops charged, by kernel
    argument_bytes: int
    output_bytes: int
    peak_bytes: int
    trace_s: float


class _Counter(TorchDispatchMode):
    """Counts the ops one rank runs: flops, bytes, collectives, ops, and
    the live storages' bytes.  It steps aside for DTensor, whose ops come
    back here on the local tensors."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.coll = CollectiveStats()
        self.ops: Dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self.quiet = 0        # > 0 inside DTensor's sharding propagation
        self._seen: "weakref.WeakSet" = weakref.WeakSet()

    def track(self, t) -> None:
        """Count ``t``'s storage as live until it is freed."""
        if isinstance(t, DTensor):
            t = t._local_tensor
        if not isinstance(t, torch.Tensor) or t.device.type == "meta":
            return
        st = t.untyped_storage()
        if st in self._seen:
            return
        self._seen.add(st)
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        name = func._opname
        if self.quiet or name == "wait_tensor":
            return out
        self.ops[name] = self.ops.get(name, 0) + 1
        ins = [t for t in pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        for t in outs:
            self.track(t)
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d"):
            kind = COLLECTIVES.get(name, name)
            n = _nbytes(ins[0]) if ins else 0
            self.coll.bytes_by_kind[kind] = \
                self.coll.bytes_by_kind.get(kind, 0) + n
            self.coll.count_by_kind[kind] = \
                self.coll.count_by_kind.get(kind, 0) + 1
            return out
        if ns != "aten" or name in FREE:
            return out
        io = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            f = float(formula(*args, **kwargs, out_val=out))
            self.cost.flops += f
            self.cost.dot_flops += f
            self.cost.bytes += io
            return out
        self.cost.flops += sum(t.numel() for t in outs)
        if name in MATERIALIZING:
            self.cost.bytes += io
        return out


# the sharding propagator's entry points that run ops on global-shape fake
# tensors (instance attributes: the cached one wraps the uncached one)
_PROPAGATION = ("propagate_op_sharding", "propagate_op_sharding_non_cached",
                "propagate")


@contextmanager
def _quiet_propagation(counter: _Counter):
    """Mark the counter quiet while DTensor's sharding propagation runs."""
    prop = DTensor._op_dispatcher.sharding_propagator
    saved = {n: getattr(prop, n) for n in _PROPAGATION if hasattr(prop, n)}
    own = {n for n in saved if n in vars(prop)}
    if not saved:
        raise RuntimeError("DTensor's sharding propagator has none of "
                           f"{_PROPAGATION}: the trace cannot tell its ops "
                           "from the rank's")

    def quiet(fn):
        def run(*a, **k):
            counter.quiet += 1
            try:
                return fn(*a, **k)
            finally:
                counter.quiet -= 1
        return run
    for n, fn in saved.items():
        setattr(prop, n, quiet(fn))
    try:
        yield
    finally:
        for n in saved:
            if n in own:
                setattr(prop, n, saved[n])
            else:
                delattr(prop, n)


def _fake_mode_of(leaves) -> FakeTensorMode:
    for t in leaves:
        if isinstance(t, DTensor):
            t = t._local_tensor
        if isinstance(t, FakeTensor):
            return t.fake_mode
    return None


def _to_fake(mode: FakeTensorMode, t):
    """A tensor argument as a fake one (a meta tensor: on the CPU)."""
    if not isinstance(t, torch.Tensor) or isinstance(t, (FakeTensor,
                                                         DTensor)):
        return t
    with mode:
        f = torch.empty(t.shape, dtype=t.dtype,
                        device="cpu" if t.device.type == "meta"
                        else t.device)
    return f.requires_grad_(t.requires_grad)


def trace(fn: Callable, *args) -> Tuple[Any, Trace]:
    """Run ``fn(*args)`` once on fake tensors under the counters: (its
    output, the trace).  Arguments that are not fake are made fake of
    their shapes and dtypes (a meta tensor stands for a
    ``ShapeDtypeStruct``)."""
    leaves, spec = pytree.tree_flatten(args)
    mode = _fake_mode_of(leaves) or FakeTensorMode(allow_non_fake_inputs=True)
    leaves = [_to_fake(mode, t) for t in leaves]
    args = pytree.tree_unflatten(leaves, spec)
    counter = _Counter()
    arg_bytes = 0
    for t in leaves:
        if isinstance(t, torch.Tensor):
            counter.track(t)
            arg_bytes += _nbytes(t._local_tensor if isinstance(t, DTensor)
                                 else t)
    t0 = time.perf_counter()
    with mode, charging() as charges, _quiet_propagation(counter), counter:
        out = fn(*args)
    dt = time.perf_counter() - t0
    outs = [t._local_tensor if isinstance(t, DTensor) else t
            for t in pytree.tree_leaves(out) if isinstance(t, torch.Tensor)]
    out_bytes = sum(_nbytes(t) for t in outs)
    cost = counter.cost
    cost.bytes += arg_bytes + out_bytes
    for name in charges.calls:
        cost.flops += charges.flops[name]
        cost.bytes += charges.bytes[name]
        if name in DOT_KERNELS:
            cost.dot_flops += charges.flops[name]
    return out, Trace(cost, counter.coll, dict(counter.ops), charges,
                      arg_bytes, out_bytes, counter.peak, dt)


def cost_of(fn: Callable, *args) -> Cost:
    """Trace ``fn(*args)`` (fake or meta tensors fine) and return its Cost."""
    return trace(fn, *args)[1].cost


def collective_stats(tr: Trace) -> CollectiveStats:
    """Per-device operand bytes and counts of the trace's collectives, by
    kind (every loop iteration counted: the reference's trip-aware
    census)."""
    return tr.collectives


def op_census(tr: Trace, top: int = 24) -> Dict[str, int]:
    """The kernel ops charged, by kernel, and the ``top`` most frequent
    aten ops (the reference counts HLO ops: dots, fusions, custom calls)."""
    out = {f"kernel:{k}": n for k, n in sorted(tr.kernels.calls.items())}
    ops = sorted(tr.ops.items(), key=lambda kv: -kv[1])[:top]
    out.update(dict(ops))
    return out


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: float) -> dict:
    """The three per-step roofline terms in seconds (per-device numbers),
    against an H100's bf16 peak, HBM bandwidth and slowest link."""
    compute_s = flops_per_dev / PEAK_FLOPS["bfloat16"]
    memory_s = bytes_per_dev / HBM_BYTES_PER_S
    collective_s = coll_bytes_per_dev / LINK_BYTES_PER_S
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s,
             "flops_per_dev": flops_per_dev,
             "bytes_per_dev": bytes_per_dev,
             "collective_bytes_per_dev": coll_bytes_per_dev}
    terms["bound"] = max(
        ("compute", compute_s), ("memory", memory_s),
        ("collective", collective_s), key=lambda kv: kv[1])[0]
    terms["step_s"] = max(compute_s, memory_s, collective_s)
    return terms
