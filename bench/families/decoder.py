"""The family of ``model_type`` ``llama`` and ``phimoe``: a decoder of
period 1, GQA attention then a gated dense FFN or a capacity-dropping MoE.
Its spec, the program's configuration, the weights' layout, the plain
reference and the work counts, in that order (the family interface:
``bench/families/__init__.py``).

The reference, in float32 PyTorch with no kernel, cache or batching of the
program, follows the equations the configuration states (``assumed`` in its
file): RMSNorm scaled by (1 + w); rotary embeddings on the two halves of
each head (theta from the config); causal attention with each query head
reading key head h // (H / KVH); the dense FFN silu(h Wg) * (h Wu) Wd on
the normed residual; the MoE FFN on the un-normalized residual, a softmax
router in f32, its top-k by a stable descending sort, renormalized, each
expert's rows capped at ``capacity(T * k)`` in token-major pair order (the
pairs beyond it dropped), the kept pairs' outputs summed by their gates;
the final norm, the head (tied: the embedding's transpose) and the mean
cross-entropy.  Every product goes through ``Precision.mm``, float32 with
TF32 off unless a control asks for less.

The parameters are a dict of groups in the program's layout: ``embed``
``tok`` (V, D); ``final`` ``ln``; ``head`` ``w`` (D, V) where untied;
``pos0`` holding each layer weight stacked over the layers: ``mix_ln``,
``mix_wq`` (D, H dh), ``mix_wk``/``mix_wv`` (D, KVH dh), ``mix_wo``,
``ffn_ln`` and either ``ffn_w_gate``/``ffn_w_up`` (D, F), ``ffn_w_down``
or ``ffn_router`` (D, E) and the expert stacks (E, D, F)/(E, F, D).

The counts: a layer's products are the attention projections, then the
dense FFN or the router and the experts' products over the T x top_k
routed pairs (no capacity padding), each expert's weights read once; a
decode step's expert products read every expert's weights; attention is
the flash kernel at (H, KVH, dh).
"""

from __future__ import annotations

import itertools
import math
import sys
from dataclasses import dataclass, field
from typing import Iterable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..cost import Work, causal_pairs, flash, matmul
from ..reference.shared import F32, Precision, capacity

# -- the spec -----------------------------------------------------------------


@dataclass(frozen=True)
class ModelSpec:
    """The shapes and dtypes the benchmark reads from a configuration."""

    name: str
    model_type: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    tie_embeddings: bool
    norm_eps: float
    rope_theta: float
    param_dtype: str
    compute_dtype: str
    logits_dtype: str
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    norm_init_std: float = 0.1
    embed_init_std: float = 0.02
    residual_init_scale: float = 1.0
    family: object = field(default=None, compare=False, repr=False)


# the configuration keys read into ``ModelSpec`` beyond the shared ones,
# and the values it builds
READ = {"num_hidden_layers", "hidden_size", "num_attention_heads",
        "num_key_value_heads", "head_dim", "intermediate_size",
        "vocab_size", "tie_word_embeddings", "rms_norm_eps", "rope_theta",
        "num_local_experts", "num_experts_per_tok"}
BUILT = {"hidden_act": {"silu"}}


def spec(cfg: dict) -> ModelSpec:
    run = cfg["run"]
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    E = cfg.get("num_local_experts", 0)
    return ModelSpec(
        name=cfg["name"], model_type=cfg["model_type"],
        n_layers=cfg["num_hidden_layers"], d_model=D,
        n_heads=H, n_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg.get("head_dim") or D // H,
        d_ff=0 if E else cfg["intermediate_size"],
        vocab=cfg["vocab_size"],
        tie_embeddings=cfg["tie_word_embeddings"],
        norm_eps=cfg["rms_norm_eps"], rope_theta=cfg["rope_theta"],
        param_dtype=run["param_dtype"], compute_dtype=run["compute_dtype"],
        logits_dtype=run["logits_dtype"], n_experts=E,
        top_k=cfg.get("num_experts_per_tok", 0),
        d_ff_expert=cfg["intermediate_size"] if E else 0,
        capacity_factor=run.get("capacity_factor", 1.25),
        norm_init_std=run["norm_init_std"],
        embed_init_std=run.get("embed_init_std", 0.02),
        residual_init_scale=run.get("residual_init_scale", 1.0))


# -- the program's configuration and the weights' layout ----------------------

def arch_config(spec):
    from repro_torch.configs.base import ArchConfig, MoEConfig
    moe = None
    if spec.n_experts:
        moe = MoEConfig(n_experts=spec.n_experts, top_k=spec.top_k,
                        d_ff_expert=spec.d_ff_expert,
                        capacity_factor=spec.capacity_factor)
    return ArchConfig(
        name=spec.name, family="moe" if moe else "dense",
        n_layers=spec.n_layers, d_model=spec.d_model, n_heads=spec.n_heads,
        n_kv_heads=spec.n_kv_heads, d_ff=spec.d_ff or spec.d_ff_expert,
        vocab=spec.vocab, pattern=("attn",),
        ffn_pattern=("moe",) if moe else ("dense",), moe=moe,
        d_head=spec.head_dim, rope_theta=spec.rope_theta,
        norm_eps=spec.norm_eps, tie_embeddings=spec.tie_embeddings)


def layout(spec):
    """(shape, std) of every parameter, in the program's layout: groups
    ``pos0`` (each layer weight stacked over the layers), ``embed``,
    ``head`` (untied only) and ``final``.  The embedding N(0,
    ``embed_init_std``^2), each product's weight N(0, 1 / fan_in), the
    products that end a residual branch (``wo``, ``w_down``) scaled further
    by ``residual_init_scale`` (GPT-2's 1 / sqrt(2 L), so that the residual
    stays near the embedding's scale through many layers), each norm weight
    N(0, ``norm_init_std``^2) (not zero: a zero norm weight would hide a
    program that scales by w instead of 1 + w)."""
    D, V, L = spec.d_model, spec.vocab, spec.n_layers
    H, KV, dh = spec.n_heads, spec.n_kv_heads, spec.head_dim
    ln = spec.norm_init_std
    pos = {"mix_ln": ((L, D), ln),
           "mix_wq": ((L, D, H * dh), D), "mix_wk": ((L, D, KV * dh), D),
           "mix_wv": ((L, D, KV * dh), D), "mix_wo": ((L, H * dh, D), H * dh),
           "ffn_ln": ((L, D), ln)}
    if spec.n_experts:
        E, Fe = spec.n_experts, spec.d_ff_expert
        pos.update({"ffn_router": ((L, D, E), D),
                    "ffn_w_gate": ((L, E, D, Fe), D),
                    "ffn_w_up": ((L, E, D, Fe), D),
                    "ffn_w_down": ((L, E, Fe, D), Fe)})
    else:
        F_ = spec.d_ff
        pos.update({"ffn_w_gate": ((L, D, F_), D),
                    "ffn_w_up": ((L, D, F_), D),
                    "ffn_w_down": ((L, F_, D), F_)})
    out = {"pos0": {k: (s, v if k.endswith("_ln") else 1 / math.sqrt(v)
                        * (spec.residual_init_scale
                           if k in ("mix_wo", "ffn_w_down") else 1.0))
                    for k, (s, v) in pos.items()},
           "embed": {"tok": ((V, D), spec.embed_init_std)}}
    if not spec.tie_embeddings:
        out["head"] = {"w": ((D, V), 1 / math.sqrt(D))}
    out["final"] = {"ln": ((D,), ln)}
    return out


# -- the reference ------------------------------------------------------------

# rows of queries (and of the head's logits) a block of the reference
QUERY_BLOCK = 1024
HEAD_ROWS = 4096


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + w)


def rope(x, positions, theta):
    """x (B, S, heads, d) rotated by position, halves paired."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64,
                                    device=x.device) / half)
    ang = positions.double()[:, None] * freqs
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, prec: Precision):
    """Causal GQA: q (B, S, H, d), k and v (B, S, KVH, d), query i sees keys
    0..i; computed a block of queries at a time."""
    B, S, H, d = q.shape
    g = H // k.shape[2]
    k = k.repeat_interleave(g, dim=2).transpose(1, 2)      # (B, H, S, d)
    v = v.repeat_interleave(g, dim=2).transpose(1, 2)
    qt = q.transpose(1, 2)
    out = []
    for s0 in range(0, S, QUERY_BLOCK):
        s1 = min(S, s0 + QUERY_BLOCK)
        s = prec.mm(qt[:, :, s0:s1], k[:, :, :s1].transpose(-1, -2)) \
            / math.sqrt(d)
        mask = torch.arange(s1, device=q.device)[None, :] \
            <= torch.arange(s0, s1, device=q.device)[:, None]
        s = s.masked_fill(~mask, float("-inf"))
        out.append(prec.mm(torch.softmax(s, dim=-1), v[:, :, :s1]))
    return torch.cat(out, dim=2).transpose(1, 2)


def route(x, router, k, prec: Precision):
    """(gates (T, k), experts (T, k), logits (T, E)): the softmax's top k by
    a stable descending sort, renormalized."""
    logits = prec.mm(x, router)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :k], idx[:, :k]
    return gates / gates.sum(-1, keepdim=True), idx, logits


def kept_pairs(idx, n_experts: int, cap: Optional[int]):
    """Which (T, k) pairs an expert capacity of ``cap`` keeps: each expert's
    first ``cap`` pairs in token-major order (None: every pair)."""
    if cap is None:
        return torch.ones_like(idx, dtype=torch.bool)
    flat = idx.reshape(-1)
    onehot = F.one_hot(flat, n_experts)
    rank = (onehot.cumsum(0) * onehot).sum(-1) - 1
    return (rank < cap).view(idx.shape)


def expert_mix(xf, p, idx, w, prec: Precision):
    """sum over j of w[t, j] * expert idx[t, j] (xf[t]), each expert on its
    rows."""
    y = torch.zeros_like(xf)
    for e in range(p["w_gate"].shape[0]):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = xf[rows]
        h = F.silu(prec.mm(xe, p["w_gate"][e])) * prec.mm(xe, p["w_up"][e])
        y = y.index_add(0, rows, prec.mm(h, p["w_down"][e])
                        * w[rows, slot][:, None])
    return y


def moe(x, p, spec, prec: Precision, groups, record=None):
    """The MoE FFN on x (B, S, D).  ``groups``: (start, stop, capped) runs
    of positions, each a capacity group of its own over the batch's rows
    at those positions (capped False: no pair is dropped).  ``record``: a
    dict that gets each position's router logits (B * S, E)."""
    B, S, D = x.shape
    ys, logits = [], []
    for s0, s1, capped in groups:
        xf = x[:, s0:s1].reshape(-1, D)
        gates, idx, lg = route(xf, p["router"], spec.top_k, prec)
        cap = capacity(idx.numel(), spec.n_experts,
                       spec.capacity_factor) if capped else None
        keep = kept_pairs(idx, spec.n_experts, cap)
        ys.append(expert_mix(xf, p, idx, gates * keep, prec)
                  .view(B, s1 - s0, D))
        logits.append(lg.view(B, s1 - s0, -1))
    if record is not None:
        record["router"] = torch.cat(logits, dim=1)
    return torch.cat(ys, dim=1)


def layer_params(params, j):
    return {k[4:] if k.startswith("mix_") else k: v[j]
            for k, v in params["pos0"].items()}


def block(x, p, spec, prec, positions, groups, record=None):
    """One layer: x + attention, then + the FFN.  ``record``: a dict that
    gets the layer's input ``x``, its rotated keys ``k`` and values ``v``
    and, with experts, the router's logits."""
    B, S, D = x.shape
    H, KV, dh = spec.n_heads, spec.n_kv_heads, spec.head_dim
    h = rms_norm(x, p["ln"], spec.norm_eps)
    q = rope(prec.mm(h, p["wq"]).view(B, S, H, dh), positions,
             spec.rope_theta)
    k = rope(prec.mm(h, p["wk"]).view(B, S, KV, dh), positions,
             spec.rope_theta)
    v = prec.mm(h, p["wv"]).view(B, S, KV, dh)
    if record is not None:
        record.update(x=x, k=k, v=v)
    x = x + prec.mm(attention(q, k, v, prec).reshape(B, S, H * dh), p["wo"])
    if spec.n_experts:
        f = {n[4:]: p[n] for n in ("ffn_router", "ffn_w_gate", "ffn_w_up",
                                   "ffn_w_down")}
        return x + moe(x, f, spec, prec, groups, record)
    h = rms_norm(x, p["ffn_ln"], spec.norm_eps)
    g = F.silu(prec.mm(h, p["ffn_w_gate"])) * prec.mm(h, p["ffn_w_up"])
    return x + prec.mm(g, p["ffn_w_down"])


def hidden(params, tokens, spec, prec: Precision = F32, groups=None,
           remat: bool = False, records=None):
    """The final normed hidden states (B, S, D) of ``tokens`` (B, S).
    ``groups``: the MoE's capacity groups (default: all positions one
    capped group); ``remat``: each layer under a checkpoint, so that a
    backward holds one layer's activations at a time; ``records``: a list
    that gets each layer's record (``block``)."""
    B, S = tokens.shape
    groups = groups or [(0, S, True)]
    x = params["embed"]["tok"][tokens]
    positions = torch.arange(S, device=tokens.device)
    for j in range(spec.n_layers):
        p = layer_params(params, j)
        if remat:
            x = checkpoint(block, x, p, spec, prec, positions, groups,
                           use_reentrant=False)
        else:
            rec = None if records is None else {}
            x = block(x, p, spec, prec, positions, groups, rec)
            if records is not None:
                records.append(rec)
    return rms_norm(x, params["final"]["ln"], spec.norm_eps)


def head_weight(params):
    return params["head"]["w"] if "head" in params \
        else params["embed"]["tok"].T


def _ce_rows(h, w, labels, prec):
    logits = prec.mm(h, w)
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, labels[:, None])[:, 0]).sum()


def loss(params, batch, spec, prec: Precision = F32, remat: bool = True):
    """Mean cross-entropy of the next-token logits against the labels, the
    head taken ``HEAD_ROWS`` rows at a time."""
    tokens, labels = batch["tokens"], batch["labels"]
    h = hidden(params, tokens, spec, prec, remat=remat)
    h = h.reshape(-1, h.shape[-1])
    labels = labels.reshape(-1)
    w = head_weight(params)
    total = 0.0
    for r0 in range(0, h.shape[0], HEAD_ROWS):
        args = (h[r0:r0 + HEAD_ROWS], w, labels[r0:r0 + HEAD_ROWS], prec)
        total = total + (checkpoint(_ce_rows, *args, use_reentrant=False)
                         if remat else _ce_rows(*args))
    return total / h.shape[0]


def logits_at(params, tokens, spec, rows, groups, prec: Precision = F32,
              records=None):
    """The head's logits (len(rows), V) at positions ``rows`` of one
    sequence ``tokens`` (1, S)."""
    h = hidden(params, tokens, spec, prec, groups=groups,
               records=records)[0, rows]
    return prec.mm(h, head_weight(params))


def check_slots(spec, slots: int) -> None:
    """Refuses a serving cell whose decode step over ``slots`` rows can drop
    pairs, which the per-request check cannot reproduce."""
    if spec.n_experts and capacity(slots * spec.top_k, spec.n_experts,
                                   spec.capacity_factor) < slots:
        raise ValueError("a decode step of this cell can drop pairs, which "
                         "the per-request check cannot reproduce")


# a token's routing at a layer may go either way where the reference's
# k-th and (k+1)-th router logits lie within this share of the spread of
# its router logits (``near_tie``): bf16 rounding flips such near ties, and
# either routing is the stated model's answer
TIE = 0.05


def near_tie(router, k: int, tau: float):
    """Where the k-th and (k+1)-th router logits of a token lie within
    ``tau`` times the spread (standard deviation) of its logits."""
    s = torch.sort(router, dim=-1, descending=True).values
    return (s[..., k - 1] - s[..., k]) < tau * router.std(-1)


def routings(router, k: int, tau: float):
    """The top-k expert sets that a token's near ties allow, the exact one
    first: the experts above the band of half-width ``tau`` / 2 times the
    spread around the midpoint of the k-th and (k+1)-th logits, with each
    choice of the rest from the experts inside the band."""
    order = torch.sort(router, descending=True, stable=True).indices
    s = router[order]
    mid = (s[k - 1] + s[k]) / 2
    half = tau * router.std() / 2
    sure = [int(e) for e in order if router[e] > mid + half]
    band = [int(e) for e in order if abs(router[e] - mid) <= half]
    out = [order[:k].tolist()]
    for rest in itertools.combinations(band, k - len(sure)):
        if sorted(sure + list(rest)) != sorted(out[0]):
            out.append(sure + list(rest))
    return [torch.tensor(c, device=router.device) for c in out]


def tied_variants(params, spec, records, i, tau, prec: Precision = F32):
    """The logits (n, V) of position i of one sequence under every routing
    of its near ties: at each layer, every top-k set ``routings`` allows
    from that layer's input at i; the other positions' keys and values are
    the recorded ones.  Capacity drops are not applied (a near tie's
    variants stand beside the exact pass's logits)."""
    H, KV, dh, k_ = spec.n_heads, spec.n_kv_heads, spec.head_dim, spec.top_k
    pos = torch.tensor([i], device=records[0]["x"].device)
    xs = [records[0]["x"][0, i][None]]
    for j, rec in enumerate(records):
        p = layer_params(params, j)
        nxt = []
        for x in xs:
            h = rms_norm(x, p["ln"], spec.norm_eps)
            q = rope(prec.mm(h, p["wq"]).view(1, 1, H, dh), pos,
                     spec.rope_theta)
            kk = rope(prec.mm(h, p["wk"]).view(1, 1, KV, dh), pos,
                      spec.rope_theta)
            vv = prec.mm(h, p["wv"]).view(1, 1, KV, dh)
            keys = torch.cat([rec["k"][0, :i], kk[0]])         # (i+1, KV, d)
            vals = torch.cat([rec["v"][0, :i], vv[0]])
            g = H // KV
            kr = keys.repeat_interleave(g, dim=1).transpose(0, 1)
            vr = vals.repeat_interleave(g, dim=1).transpose(0, 1)
            sc = prec.mm(q[0].transpose(0, 1), kr.transpose(-1, -2)) \
                / math.sqrt(dh)                                  # (H, 1, i+1)
            o = prec.mm(torch.softmax(sc, -1), vr).transpose(0, 1)
            x = x + prec.mm(o.reshape(1, H * dh), p["wo"])
            f = {n[4:]: p[n] for n in ("ffn_router", "ffn_w_gate",
                                       "ffn_w_up", "ffn_w_down")}
            lg = prec.mm(x, f["router"])
            probs = torch.softmax(lg, dim=-1)
            for idx in routings(lg[0], k_, tau):
                w = probs[0, idx] / probs[0, idx].sum()
                nxt.append(x + expert_mix(x, f, idx[None], w[None], prec))
        xs = nxt
    h = rms_norm(torch.cat(xs), params["final"]["ln"], spec.norm_eps)
    return prec.mm(h, head_weight(params))


def candidates(params, tokens, spec, rows, groups, prec: Precision = F32):
    """Per position of ``rows`` in one sequence ``tokens`` (1, S), the
    logits (n, V) under each routing its near ties allow (the exact pass's
    first)."""
    records = []
    logits = logits_at(params, tokens, spec, rows, groups, prec, records)
    out = [logits[j][None] for j in range(len(rows))]
    if spec.n_experts:
        tied = torch.stack([near_tie(r["router"][0], spec.top_k, TIE)
                            for r in records]).any(0)
        for j, i in enumerate(rows):
            if bool(tied[i]):
                out[j] = torch.cat([out[j], tied_variants(
                    params, spec, records, i, TIE, prec)])
    return out


# -- the work counts ----------------------------------------------------------

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


# the family's reference and counts are this module's own functions
reference = cost = sys.modules[__name__]
