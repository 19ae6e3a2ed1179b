"""The work a cell's step needs, from the configuration's shapes alone.

What a step needs, not what a given implementation does: a training step's
products are counted forward once and backward twice (dA and dB), with
nothing recomputed; the MoE experts' products over the T x top_k routed
pairs (no capacity padding), each expert's weights read once; a decode
step's expert products read every expert's weights.  Model flops (the
numerator of a flops utilization) are 2 flops per multiply-add of the
products a token needs, plus causal attention's QK and PV products;
training's are three times the forward's.
"""

from __future__ import annotations

from typing import Iterable

from . import Work, causal_pairs, flash, matmul


def layer_forward(spec, T: int) -> Work:
    """One layer's products over T tokens (attention projections, then the
    dense FFN or the router and the experts' routed pairs)."""
    D, H, KV, dh = spec.d_model, spec.n_heads, spec.n_kv_heads, spec.head_dim
    dt = spec.compute_dtype
    w = (matmul(T, D, H * dh, dt) + 2 * matmul(T, D, KV * dh, dt)
         + matmul(T, H * dh, D, dt))
    if spec.n_experts:
        E, Fe, pairs = spec.n_experts, spec.d_ff_expert, T * spec.top_k
        return (w + matmul(T, D, E, dt)
                + 2 * matmul(pairs, D, Fe, dt, n_weights=E)
                + matmul(pairs, Fe, D, dt, n_weights=E))
    return w + 2 * matmul(T, D, spec.d_ff, dt) + matmul(T, spec.d_ff, D, dt)


def head(spec, rows: int) -> Work:
    return matmul(rows, spec.d_model, spec.vocab, spec.logits_dtype)


def train_matmul(spec, batch: int, seq: int, grad_accum: int) -> Work:
    """A training step's products: forward, dA and dB of every product of
    every microbatch."""
    T = batch * seq // grad_accum
    return 3 * grad_accum * (spec.n_layers * layer_forward(spec, T)
                             + head(spec, T))


def train_flash(spec, batch: int, seq: int, grad_accum: int) -> Work:
    """A training step's attention kernels: forward and backward a layer a
    microbatch."""
    b = batch // grad_accum
    args = (b, seq, spec.n_heads, spec.n_kv_heads, spec.head_dim,
            spec.compute_dtype)
    return grad_accum * spec.n_layers * (flash(*args)
                                         + flash(*args, backward=True))


def active_layer_params(spec) -> int:
    """The product parameters one token passes through in a layer."""
    D, H, KV, dh = spec.d_model, spec.n_heads, spec.n_kv_heads, spec.head_dim
    attn = 2 * D * H * dh + 2 * D * KV * dh
    if spec.n_experts:
        return (attn + D * spec.n_experts
                + spec.top_k * 3 * D * spec.d_ff_expert)
    return attn + 3 * D * spec.d_ff


def attention_flops(spec, sq: int, skv: int) -> float:
    """QK and PV of sq queries at the end of skv keys, all layers."""
    return (spec.n_layers * 4 * spec.head_dim * spec.n_heads
            * causal_pairs(sq, skv))


def train_model_flops(spec, batch: int, seq: int) -> float:
    """6 flops per parameter per token, plus attention's three passes."""
    tokens = batch * seq
    per_token = spec.n_layers * active_layer_params(spec) \
        + spec.d_model * spec.vocab
    return 6 * per_token * tokens + 3 * batch * attention_flops(spec, seq, seq)


def prefill_matmul(spec, n: int) -> Work:
    """A prefill of one n-token prompt: every layer over n tokens, the head
    at the last position only."""
    return spec.n_layers * layer_forward(spec, n) + head(spec, 1)


def prefill_flash(spec, n: int) -> Work:
    return spec.n_layers * flash(1, n, spec.n_heads, spec.n_kv_heads,
                                 spec.head_dim, spec.compute_dtype)


def prefill_model_flops(spec, n: int) -> float:
    return (2 * (spec.n_layers * active_layer_params(spec) * n
                 + spec.d_model * spec.vocab) + attention_flops(spec, n, n))


def decode_matmul(spec, rows: int) -> Work:
    """A decode step of ``rows`` tokens: every layer's products (every
    expert's weights read) and the head."""
    return spec.n_layers * layer_forward(spec, rows) + head(spec, rows)


def decode_model_flops(spec, positions: Iterable[int]) -> float:
    """One new token at each of ``positions`` (its key position; it sees
    position + 1 keys)."""
    per_token = 2 * (spec.n_layers * active_layer_params(spec)
                     + spec.d_model * spec.vocab)
    total = 0.0
    for t in positions:
        total += per_token + (spec.n_layers * 4 * spec.head_dim
                              * spec.n_heads * (t + 1))
    return total
