"""The work a cell's step needs, from the configuration's shapes alone,
counted by the spec's family (its ``cost``, ``bench/families``): each name
here passes its call on, so that a metric's reader needs no edit for a new
family.

Every family counts what a step needs, not what a given implementation
does: a training step's products forward once and backward twice (dA and
dB), with nothing recomputed; an MoE's expert products over the routed
pairs (no capacity padding), each expert's weights read once; a decode
step's expert products read every expert's weights.  Model flops (the
numerator of a flops utilization) are 2 flops per multiply-add of the
products a token needs, plus causal attention's QK and PV products;
training's are three times the forward's.
"""

from __future__ import annotations

from typing import Iterable

from . import Work


def layer_forward(spec, T: int) -> Work:
    """One layer's products over T tokens."""
    return spec.family.cost.layer_forward(spec, T)


def head(spec, rows: int) -> Work:
    return spec.family.cost.head(spec, rows)


def train_matmul(spec, batch: int, seq: int, grad_accum: int) -> Work:
    """A training step's products: forward, dA and dB of every product of
    every microbatch."""
    return spec.family.cost.train_matmul(spec, batch, seq, grad_accum)


def train_flash(spec, batch: int, seq: int, grad_accum: int) -> Work:
    """A training step's attention kernels: forward and backward a layer a
    microbatch."""
    return spec.family.cost.train_flash(spec, batch, seq, grad_accum)


def active_layer_params(spec) -> int:
    """The product parameters one token passes through in a layer."""
    return spec.family.cost.active_layer_params(spec)


def attention_flops(spec, sq: int, skv: int) -> float:
    """QK and PV of sq queries at the end of skv keys, all layers."""
    return spec.family.cost.attention_flops(spec, sq, skv)


def train_model_flops(spec, batch: int, seq: int) -> float:
    """6 flops per parameter per token, plus attention's three passes."""
    return spec.family.cost.train_model_flops(spec, batch, seq)


def prefill_matmul(spec, n: int) -> Work:
    """A prefill of one n-token prompt: every layer over n tokens, the head
    at the last position only."""
    return spec.family.cost.prefill_matmul(spec, n)


def prefill_flash(spec, n: int) -> Work:
    return spec.family.cost.prefill_flash(spec, n)


def prefill_model_flops(spec, n: int) -> float:
    return spec.family.cost.prefill_model_flops(spec, n)


def decode_matmul(spec, rows: int) -> Work:
    """A decode step of ``rows`` tokens: every layer's products (every
    expert's weights read) and the head."""
    return spec.family.cost.decode_matmul(spec, rows)


def decode_model_flops(spec, positions: Iterable[int]) -> float:
    """One new token at each of ``positions`` (its key position; it sees
    position + 1 keys)."""
    return spec.family.cost.decode_model_flops(spec, positions)
