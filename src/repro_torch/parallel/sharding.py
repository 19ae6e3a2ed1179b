"""Logical-axis sharding rules (t5x-style), the port's single source of
sharding truth (port of ``repro.parallel.sharding``).

Model code annotates activations with *logical* axis names
(``annotate(x, 'batch', 'seq', 'embed')``); every weight has logical axes
(``models/model.py`` ``param_axes``).  A ``ShardingRules`` table maps
logical names to mesh axes.  The mapping is what the autotuner tunes: rule
variants are points of the configuration space.

Divisibility fallback: if a dimension is not divisible by the product of its
assigned mesh axes, trailing mesh axes are dropped until it is -- so the same
rule table serves every (arch x shape) cell.

The table logic is the reference's, close to verbatim; it reads only the
mesh's axis names and sizes (``mesh_dim_names`` and ``shape``, which a
``DeviceMesh`` and a ``MeshShape`` both have), so the rules run without a
process group.  What differs is how a spec reaches the tensors.  In JAX the
rules only place arrays and XLA's SPMD partitioner writes the collectives;
here a spec becomes DTensor placements (``placements``), ``annotate`` is a
``redistribute`` (as ``with_sharding_constraint`` is in JAX), and the
kernels, which DTensor cannot look inside, run under per-op placement rules
(``kernels/ops.py``).

A tuple of mesh axes on one tensor dim shards it major-first in the tuple's
order in JAX; DTensor shards a dim held by several mesh dims in mesh-dim
order.  Every tuple of the four tables lists its axes in mesh order, so the
two agree; ``placements`` checks it for every spec.

The port stores attention and MLA projections 2-D where the JAX tensors are
3-D (``models/layers.py``): a spec is computed on the JAX shape and mapped
onto the merged dims by ``merge_spec``.
"""

from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.utils._pytree as pytree
from torch.distributed.tensor import (DTensor, Partial, Placement, Replicate,
                                      Shard, distribute_tensor)
from torch.distributed.tensor.experimental import local_map

MeshAxes = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), a mesh axis name, or a
    tuple of them (major first); trailing Nones are dropped."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without devices: what the rules read
    (the rule tests, and the dry-run's meshes)."""

    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def mesh_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclass(frozen=True)
class ShardingRules:
    """logical axis name -> mesh axis (or tuple of mesh axes, major first)."""

    name: str
    table: Dict[str, MeshAxes]
    mesh: Optional[object] = None     # DeviceMesh or MeshShape

    def mesh_axes(self, logical: str) -> Tuple[str, ...]:
        v = self.table.get(logical)
        if v is None:
            return ()
        if isinstance(v, str):
            return (v,)
        return tuple(v)

    def spec(self, *logical: Optional[str],
             dims: Optional[Sequence[int]] = None) -> PartitionSpec:
        """PartitionSpec for a tensor whose dims carry the given logical
        names (None = replicated dim). ``dims`` enables the divisibility
        fallback; pass the concrete shape when available."""
        used = set()
        out = []
        for i, name in enumerate(logical):
            if name is None:
                out.append(None)
                continue
            axes = [a for a in self.mesh_axes(name) if a not in used]
            if dims is not None and self.mesh is not None:
                axes = _fit_axes(axes, int(dims[i]), self.mesh)
            if not axes:
                out.append(None)
            elif len(axes) == 1:
                out.append(axes[0])
                used.add(axes[0])
            else:
                out.append(tuple(axes))
                used.update(axes)
        while out and out[-1] is None:
            out.pop()
        return P(*out)

    def with_mesh(self, mesh) -> "ShardingRules":
        # drop assignments to axes the mesh does not have (e.g. 'pod' on the
        # single-pod mesh)
        axis_names = set(mesh.mesh_dim_names)
        table = {}
        for k, v in self.table.items():
            axes = (v,) if isinstance(v, str) else tuple(v or ())
            axes = tuple(a for a in axes if a in axis_names)
            table[k] = axes if axes else None
        return ShardingRules(self.name, table, mesh)

    def override(self, **kw: MeshAxes) -> "ShardingRules":
        t = dict(self.table)
        t.update(kw)
        return ShardingRules(self.name, t, self.mesh)


def _fit_axes(axes, dim, mesh):
    """Drop trailing mesh axes until the dim is divisible by their product."""
    sizes = mesh_sizes(mesh)
    while axes:
        prod = math.prod(sizes[a] for a in axes)
        if prod and dim % prod == 0:
            return axes
        axes = axes[:-1]
    return []


# ---------------------------------------------------------------------------
# rule variants -- the sharding dimension of the tuning space
# ---------------------------------------------------------------------------

def make_rules(variant: str = "cp") -> ShardingRules:
    """Build one of the named rule variants (mesh attached later).

    Logical axes used by the model code:
      batch, seq        activations (tokens)
      kv_seq            KV-cache sequence dim (decode)
      embed             d_model
      heads, kv_heads   attention heads
      ffn               feed-forward hidden
      inner             ssm/xlstm inner width
      vocab             embedding/output vocabulary
      expert            MoE expert dim
      lora              MLA latent dims
      fsdp_embed        weight d_model dim for FSDP sweeps
    """
    if variant == "cp":
        # context parallelism: activations sharded batch->data, seq->model;
        # weights Megatron-sharded on ffn/vocab/experts over model and
        # FSDP-sharded on embed over data.
        table = {
            "batch": ("pod", "data"), "seq": "model", "kv_seq": "model",
            "embed": None, "heads": None, "kv_heads": None,
            "ffn": "model", "inner": "model", "vocab": "model",
            "expert": "model", "lora": "data",
            "fsdp_embed": "data", "state": None,
            "tokens": ("pod", "data", "model"),
            "exp_cap": ("pod", "data"), "head_ff": "model",
            "heads_w": "model",
        }
    elif variant == "dp":
        # pure data parallelism (+FSDP weights): batch over everything.
        table = {
            "batch": ("pod", "data", "model"), "seq": None, "kv_seq": None,
            "embed": None, "heads": None, "kv_heads": None,
            "ffn": None, "inner": None, "vocab": None,
            "expert": None, "lora": ("data", "model"),
            "fsdp_embed": ("data", "model"), "state": None,
            "tokens": ("pod", "data", "model"),
            "exp_cap": ("pod", "data", "model"), "head_ff": None,
            "heads_w": None,
        }
    elif variant == "tp":
        # Megatron head-parallel attention + sharded ffn; batch->data only.
        # Arch-dependent: requires n_heads % model == 0 (fallback drops it).
        table = {
            "batch": ("pod", "data"), "seq": None, "kv_seq": None,
            "embed": None, "heads": "model", "kv_heads": "model",
            "ffn": "model", "inner": "model", "vocab": "model",
            "expert": "model", "lora": "data",
            "fsdp_embed": "data", "state": None,
            "tokens": ("pod", "data"),
            "exp_cap": ("pod", "data"), "head_ff": "model",
            "heads_w": "model",
        }
    elif variant == "cp_fsdp":
        # cp + aggressive FSDP: every weight embed dim sharded over data,
        # activations identical to cp.
        base = make_rules("cp").table
        table = dict(base)
        table["embed"] = None
        table["fsdp_embed"] = "data"
    else:
        raise ValueError(f"unknown sharding variant {variant!r}")
    return ShardingRules(variant, table)


RULE_VARIANTS = ("cp", "dp", "tp", "cp_fsdp")


# ---------------------------------------------------------------------------
# thread-local active rules + annotate()
# ---------------------------------------------------------------------------

_tls = threading.local()


def current_rules() -> Optional[ShardingRules]:
    return getattr(_tls, "rules", None)


@contextmanager
def axis_rules(rules: Optional[ShardingRules]):
    prev = getattr(_tls, "rules", None)
    _tls.rules = rules
    try:
        yield rules
    finally:
        _tls.rules = prev


def logical_spec(shape: Sequence[int], *logical: Optional[str]
                 ) -> PartitionSpec:
    """PartitionSpec under the active rules (empty spec when none active)."""
    rules = current_rules()
    if rules is None or rules.mesh is None:
        return P()
    return rules.spec(*logical, dims=shape)


def is_axes_leaf(x) -> bool:
    """True for a logical-axes tuple like ('layers', 'embed', None)."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) for e in x)


def map_axes(fn, axes_tree, *trees):
    """A map over nested dicts whose leaves in ``axes_tree`` are
    logical-axes tuples (the reference's ``tree_map`` with
    ``is_axes_leaf``)."""
    if is_axes_leaf(axes_tree):
        return fn(axes_tree, *trees)
    return {k: map_axes(fn, v, *(t[k] for t in trees))
            for k, v in axes_tree.items()}


# ---------------------------------------------------------------------------
# specs -> DTensor placements
# ---------------------------------------------------------------------------

def placements(spec: Sequence[MeshAxes], mesh) -> Tuple[Placement, ...]:
    """DTensor placements (one per mesh dim) of a spec: ``Shard(d)`` on
    every mesh dim that the spec's entry for tensor dim d names, else
    ``Replicate``.  Raises where a tuple of axes is not in mesh order (JAX
    would shard it in another order than DTensor)."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {tuple(spec)}: dim {d} lists mesh axes "
                             f"{axes} out of the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def local_shape(shape: Sequence[int], mesh, pl) -> Tuple[int, ...]:
    """A rank's shard shape of a tensor of ``shape`` under placements
    ``pl`` on ``mesh``, whose sharded dims split evenly (as the rules'
    divisibility fallback leaves them)."""
    out = list(shape)
    for i, p in enumerate(pl):
        if p.is_shard():
            n = mesh.size(i)
            if out[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"split evenly over mesh dim {i}")
            out[p.dim] //= n
    return tuple(out)


def merge_spec(spec: Sequence[MeshAxes], src_shape: Sequence[int],
               dst_shape: Sequence[int]) -> PartitionSpec:
    """A spec for ``src_shape`` mapped onto ``dst_shape``, whose every dim
    is the product of consecutive dims of ``src_shape`` (the port's 2-D
    attention weights against the JAX 3-D ones).  A merged dim takes the
    entry of its major source dim (after any of size 1): sharding H of (H,
    dh) over m ranks is sharding H*dh contiguously over m.  A minor source
    dim that is sharded cannot be expressed and raises."""
    entries = list(spec) + [None] * (len(src_shape) - len(spec))
    out, i = [], 0
    for n in dst_shape:
        group, size = [], 1
        while i < len(src_shape) and (not group or size < n):
            group.append(i)
            size *= src_shape[i]
            i += 1
        if size != n:
            raise ValueError(f"{tuple(dst_shape)} does not merge the dims "
                             f"of {tuple(src_shape)}")
        # the major dims of size 1 contribute nothing to the order
        while len(group) > 1 and src_shape[group[0]] == 1 \
                and entries[group[0]] is None:
            group.pop(0)
        if any(entries[j] is not None for j in group[1:]):
            raise ValueError(f"spec {tuple(spec)} shards a minor dim of "
                             f"{tuple(src_shape)} merged into "
                             f"{tuple(dst_shape)}")
        out.append(entries[group[0]])
    if i != len(src_shape):
        raise ValueError(f"{tuple(dst_shape)} does not merge the dims of "
                         f"{tuple(src_shape)}")
    while out and out[-1] is None:
        out.pop()
    return P(*out)


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec (the JAX ``NamedSharding``); ``placements`` are
    the DTensor ones."""

    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> Tuple[Placement, ...]:
        return placements(self.spec, self.mesh)


def distribute(t: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """``t``, which every rank holds whole, as a DTensor: each rank keeps its
    own slice (no collective).  A tensor off the mesh's device type is moved
    there first."""
    mesh = sharding.mesh
    if t.device.type != mesh.device_type:
        t = t.to(mesh.device_type)
    return distribute_tensor(t, mesh, sharding.placements,
                             src_data_rank=None)


def place(tree, shardings):
    """A tree of nested dicts that every rank holds whole, as DTensors
    placed by the same-structure ``shardings`` tree (``distribute``)."""
    if isinstance(tree, dict):
        return {k: place(v, shardings[k]) for k, v in tree.items()}
    return distribute(tree, shardings)


def gather(tree):
    """Every DTensor of a tree of nested dicts as its full tensor (a
    collective: every rank calls it); other leaves as they are."""
    if isinstance(tree, dict):
        return {k: gather(v) for k, v in tree.items()}
    return tree.full_tensor() if isinstance(tree, DTensor) else tree


def replicate_like(t: torch.Tensor, ref) -> torch.Tensor:
    """``t`` (the same on every rank) as a replicated DTensor on ``ref``'s
    mesh where ``ref`` is a DTensor; ``t`` itself otherwise."""
    if not isinstance(ref, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def annotate(x, *logical: Optional[str]):
    """The analogue of ``with_sharding_constraint`` under the active rules:
    a DTensor is redistributed to the spec of its logical axes; a plain
    tensor, or any tensor with no rules active, is returned unchanged (as
    the reference does without rules)."""
    rules = current_rules()
    if rules is None or rules.mesh is None or not isinstance(x, DTensor):
        return x
    spec = rules.spec(*logical, dims=x.shape)
    return x.redistribute(rules.mesh, placements(spec, rules.mesh))


def reshape(x, shape):
    """``x.reshape(shape)``.  A DTensor is reshaped rank by rank: where its
    placements shard only its first dim, over n ranks, and n divides the
    new first dim, each rank's block of rows is its block of the result
    (the blocks stay in mesh order, as JAX lays out the same spec); any
    other goes through a replicated copy, which the caller then annotates.
    DTensor's own view is not used: of a DTensor sharded on two dims it
    refuses, or leaves a strided layout that is not JAX's (which tokens
    share a rank decides the MoE capacity's drops), and the gradient of a
    view may arrive in placements it cannot view back."""
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    mesh = x.device_mesh
    n = math.prod(mesh.size(i) for i, p in enumerate(x.placements)
                  if p.is_shard(0))
    if shape[0] % n or any(not (p.is_replicate() or p.is_shard(0))
                           for p in x.placements):
        x, n = x.redistribute(mesh, (Replicate(),) * mesh.ndim), 1
    local = x.to_local().reshape(shape[0] // n, *shape[1:])
    return DTensor.from_local(local, mesh, x.placements, run_check=False)


def on_shards(fn, rule, *tensors):
    """``fn`` on each rank's local tensors under ``rule``: the inputs are
    redistributed to the placements the rule accepts, ``fn`` runs on the
    local tensors as it would on one device, and its one output is a
    DTensor with the rule's output placements.  The rule's gradient
    placements tell autograd how each local gradient sums to the global one
    (``local_map``'s ``in_grad_placements``).  ``rule(*tensors)`` returns
    (input placements, output placements, input gradient placements).  The
    kernel ops' rules are in ``kernels/ops.py``.  Every input must be a
    DTensor."""
    if not all(isinstance(t, DTensor) for t in tensors):
        raise TypeError("an op with a placement rule got DTensors mixed with "
                        "plain tensors; place every input on the mesh")
    ins, outs, grads = rule(*tensors)
    mapped = local_map(fn, out_placements=(outs,), in_placements=ins,
                       in_grad_placements=grads,
                       device_mesh=tensors[0].device_mesh,
                       redistribute_inputs=True)
    return mapped(*tensors)


def take_rule(idx, table):
    """Rows of ``table`` (V, ...) at integer ``idx`` (an embedding gather):
    the table is gathered, the indices keep their placements and the
    output takes them; the table's gradient is a partial sum over the mesh
    dims that shard the indices.  (DTensor's own embedding rule shards the
    table's vocabulary with a masked partial sum, which does not hold
    indices sharded on another mesh dim.)"""
    rep = (Replicate(),) * table.device_mesh.ndim
    pi = tuple(p if p.is_shard() else Replicate() for p in idx.placements)
    g_t = tuple(Partial() if p.is_shard() else Replicate() for p in pi)
    return (pi, rep), pi, (pi, g_t)


def rows_at_rule(x, at):
    """``x[b, at[b]]`` along x's dim 1, one position a row (the prefill's
    logits position): x's batch dim keeps its placements and the indices
    and the output take them; every other dim is gathered."""
    px = tuple(p if p.is_shard(0) else Replicate() for p in x.placements)
    return (px, px), px, (px, px)


def pick_rule(x, idx):
    """``x[..., idx]`` along x's last dim, one index a row (the loss's label
    logit): x's leading dims keep their placements and the indices and the
    output take them; x's last dim is gathered.  x's gradient has x's
    placements."""
    last = x.ndim - 1
    px = tuple(p if p.is_shard() and p.dim < last else Replicate()
               for p in x.placements)
    return (px, px), px, (px, px)


# ---------------------------------------------------------------------------
# manual regions (the reference's shard_map) and in-place writes
# ---------------------------------------------------------------------------

class _ScaleGrad(torch.autograd.Function):
    """The identity whose backward scales the gradient by ``s``."""

    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def _axes_list(tree):
    """The logical-axes tuples of a tree of them (nested tuples), in
    order."""
    if is_axes_leaf(tree):
        return [tree]
    return [a for sub in tree for a in _axes_list(sub)]


def region_grads(in_pl, out_pl, mesh):
    """A manual region's gradient rule, JAX's transpose of shard_map: each
    input's gradient placements (a shard where its input is sharded, else
    ``Partial``) and the factor of each output's cotangent (1 / the number
    of ranks it is replicated over)."""
    grad_pl = tuple(tuple(p if p.is_shard() else Partial() for p in pl)
                    for pl in in_pl)
    share = [1.0 / math.prod(mesh.size(i) for i, p in enumerate(pl)
                             if not p.is_shard()) for pl in out_pl]
    return grad_pl, share


def manual(fn, arg_axes, out_axes, args):
    """``fn(*args)`` on each rank's local tensors, as the reference's
    ``shard_map(..., check_vma=False)`` runs it under the active rules (its
    ``_manual_scan``).  ``arg_axes`` and ``out_axes`` are trees of logical
    axes that match ``args`` and ``fn``'s output, leaf by leaf.  Each input
    is redistributed to the spec of its axes (a plain tensor, which every
    rank holds whole, is placed replicated first); each output's spec is
    computed on the global sizes its logical names have in the inputs.

    Gradients follow JAX's transpose of such a region: an output's
    cotangent is divided by the number of ranks it is replicated over (the
    mesh dims its spec leaves out), and an input's gradient is a partial
    sum (``Partial``) over the mesh dims its spec leaves out, a shard on the
    others.  So a weight that every rank holds whole (sLSTM's ``r``) gets
    the sum of the ranks' local gradients once, at the region's boundary,
    and an input that is replicated where the outputs are split (mLSTM's q
    and k under cp) gets the sum over the split.  Without rules, or with no
    DTensor among ``args``, ``fn(*args)`` runs as it is."""
    rules = current_rules()
    flat, _ = pytree.tree_flatten(args)
    ref = next((t for t in flat if isinstance(t, DTensor)), None)
    if rules is None or rules.mesh is None or ref is None:
        return fn(*args)
    mesh = ref.device_mesh
    in_axes = _axes_list(arg_axes)
    if len(in_axes) != len(flat):
        raise ValueError(f"{len(in_axes)} input axes for {len(flat)} "
                         f"tensors")
    sizes: Dict[str, int] = {}
    for ax, t in zip(in_axes, flat):
        for name, n in zip(ax, t.shape):
            if name is not None and sizes.setdefault(name, n) != n:
                raise ValueError(f"logical axis {name!r} has sizes "
                                 f"{sizes[name]} and {n} in one region")
    flat = [t if isinstance(t, DTensor) else replicate_like(t, ref)
            for t in flat]
    args = pytree.tree_unflatten(flat, pytree.tree_flatten(args)[1])
    in_pl = tuple(placements(rules.spec(*ax, dims=t.shape), mesh)
                  for ax, t in zip(in_axes, flat))

    def out_placements(ax):
        missing = [a for a in ax if a is not None and a not in sizes]
        if missing:
            raise ValueError(f"output axes {missing} name no input's dim")
        return placements(rules.spec(*ax, dims=[sizes.get(a, 1)
                                                for a in ax]), mesh)
    out_pl = [out_placements(ax) for ax in _axes_list(out_axes)]
    grad_pl, share = region_grads(in_pl, out_pl, mesh)

    def local(*a):
        out = fn(*a)
        leaves, spec = pytree.tree_flatten(out)
        if len(leaves) != len(out_pl):
            raise ValueError(f"{len(leaves)} outputs, {len(out_pl)} output "
                             f"axes")
        leaves = [_ScaleGrad.apply(t, s) if s != 1.0 and t.requires_grad
                  else t for t, s in zip(leaves, share)]
        return pytree.tree_unflatten(leaves, spec)
    return local_map(local, out_placements=tuple(out_pl),
                     in_placements=in_pl, in_grad_placements=grad_pl,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def local_range(t: DTensor, dim: int) -> Tuple[int, int]:
    """(offset, length) of this rank's block of ``t``'s dim ``dim``: the
    mesh dims that shard it split it in mesh-dim order, each evenly."""
    mesh = t.device_mesh
    coord = mesh.get_coordinate()
    lo, n = 0, t.shape[dim]
    for i, p in enumerate(t.placements):
        if p.is_shard(dim):
            k = mesh.size(i)
            if n % k:
                raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                                 f"split evenly over mesh dim {i}")
            n //= k
            lo += coord[i] * n
    return lo, n


def write_block(big, one, starts: Sequence[int]) -> None:
    """``big[s0:s0 + one.shape[0], s1:...] = one`` in place (``big`` holds
    no gradient).  A DTensor ``big`` is written rank by rank: each rank
    copies the part of the block that falls in its own shard, from ``one``
    redistributed to ``big``'s placements on the dims the block covers
    whole and replicated on the others.  Nothing of ``big`` moves."""
    if not isinstance(big, DTensor):
        big[tuple(slice(s, s + n) for s, n in zip(starts, one.shape))] \
            .copy_(one)
        return
    mesh = big.device_mesh
    want = tuple(p if p.is_shard() and starts[p.dim] == 0
                 and one.shape[p.dim] == big.shape[p.dim] else Replicate()
                 for p in big.placements)
    if isinstance(one, DTensor):
        src = one.redistribute(mesh, want)
    else:
        src = distribute_tensor(one.to(big.device), mesh, want,
                                src_data_rank=None)
    dst_idx, src_idx = [], []
    for d, (s, n) in enumerate(zip(starts, one.shape)):
        blo, bn = local_range(big, d)
        olo, _ = local_range(src, d)
        a, b = max(s, blo), min(s + n, blo + bn)
        if a >= b:
            return
        dst_idx.append(slice(a - blo, b - blo))
        src_idx.append(slice(a - s - olo, b - s - olo))
    with torch.no_grad():
        big.to_local()[tuple(dst_idx)].copy_(
            src.to_local()[tuple(src_idx)].to(big.dtype))
