"""The model-level remat: each period of the stack under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of the period
body, ``repro.models.model.Model._period_body_fwd``).

``ModelKnobs.remat`` picks what a period's backward keeps:

- ``"none"``: everything autograd saves;
- ``"full"``: only the period's inputs; the backward recomputes its forward
  (the reference's ``nothing_saveable``);
- ``"dots"``: the inputs and the outputs of the products with no batch
  dimension (the reference's ``checkpoint_dots_with_no_batch_dims``): every
  projection that goes through ``layers.linear`` -- attention's and MLA's
  q/k/v/o, the dense FFN, the router, the shared experts, the SSM blocks'
  projections.  What has a batch dimension is recomputed: attention (the
  flash forward), the MoE experts' products (``ecd,edf->ecf``), sLSTM's
  recurrent ``r`` (``bhk,hkg->bhg``), the scans, and every norm and
  elementwise op.

``torch.utils.checkpoint``'s selective policy sees ATen ops only, and the
products are launches of the matmul kernel through ctypes, which it cannot
see.  So the save set is marked at its call site: ``layers.linear`` calls
``product``.  A ``_Stash`` per checkpointed call holds the marked outputs.
In the first forward each marked product launches and its output is kept;
in the recompute each takes its kept output back, in call order, and
launches nothing, while its node saves the same two tensors as the
kernel's (the recompute must save what the first forward saved, in the
same order, for the checkpoint to match them).

A period is checkpointed only where autograd records it (grad enabled and
an input that requires grad), as ``ssm.chunked_scan`` does: the serving
path runs as it did.  ``chunked_scan``'s per-chunk checkpoints nest inside
a period's (non-reentrant checkpoints nest).

Under sharding rules (``parallel.sharding.axis_rules``, thread-local) the
recompute runs where autograd runs the backward, which for CUDA tensors is
its own device thread: the rules active at the checkpoint are entered
around the recompute too, so that it redistributes as the forward did.
The stash and the kept outputs then hold each rank's local tensors
(``layers.linear`` runs ``product`` on them).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels import ops
from ..parallel.sharding import axis_rules, current_rules

REMATS = ("none", "full", "dots")

# the _Stash of the "dots" period running on this thread, if any
_local = threading.local()


class _Stash:
    """The kept outputs of one checkpointed period under ``"dots"``."""

    def __init__(self):
        self.outs: List[torch.Tensor] = []
        # the recompute's next index; None while recording
        self.next: Optional[int] = None

    @contextmanager
    def _active(self, nxt):
        prev = getattr(_local, "stash", None)
        _local.stash, self.next = self, nxt
        try:
            yield
        finally:
            _local.stash = prev

    def recording(self):
        return self._active(None)

    def replaying(self):
        return self._active(0)


class _Kept(ops._Matmul):
    """The matmul's node with its output handed in: saves (a, b) as the
    kernel's node does and launches nothing."""

    @staticmethod
    def forward(ctx, a, b, out):
        ctx.save_for_backward(a, b)
        return out

    @staticmethod
    def backward(ctx, dc):
        return (*ops._Matmul.backward(ctx, dc), None)


def product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``ops.matmul(a, b)`` for a product with no batch dimension: under
    ``"dots"`` its output is kept by the forward and handed back to the
    recompute."""
    stash = getattr(_local, "stash", None)
    if stash is None:
        return ops.matmul(a, b)
    if stash.next is None:
        out = ops.matmul(a, b)
        stash.outs.append(out.detach())
        return out
    out = stash.outs[stash.next]
    stash.next += 1
    return _Kept.apply(a, b, out)


def _records(tree) -> bool:
    if isinstance(tree, torch.Tensor):
        return tree.requires_grad
    if isinstance(tree, dict):
        return any(_records(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_records(v) for v in tree)
    return False


def run(remat: str, fn: Callable, *args):
    """``fn(*args)`` under ``remat`` ("none", "full" or "dots"), checkpointed
    only where autograd records it."""
    if remat not in REMATS:
        raise ValueError(f"unknown remat {remat!r}; one of {REMATS}")
    if remat == "none" or not (torch.is_grad_enabled() and _records(args)):
        return fn(*args)
    rules = current_rules()
    if remat == "full":
        def contexts():
            return axis_rules(rules), axis_rules(rules)
    else:
        stash = _Stash()

        def contexts():
            return (_both(axis_rules(rules), stash.recording()),
                    _both(axis_rules(rules), stash.replaying()))
    # the layers draw no random numbers: no RNG state to stash
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, context_fn=contexts)


@contextmanager
def _both(a, b):
    with a, b:
        yield
