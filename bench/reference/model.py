"""The plain reference: a decoder of period 1 (GQA attention, then a gated
dense FFN or a capacity-dropping MoE) in float32 PyTorch, with no kernel,
cache or batching of the program.

It follows the equations the configuration states (``assumed`` in its
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
"""

from __future__ import annotations

import itertools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# rows of queries (and of the head's logits) a block of the reference
QUERY_BLOCK = 1024
HEAD_ROWS = 4096


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """t scaled by its largest magnitude, rounded to float8 e4m3, scaled
    back."""
    scale = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


class _Fp8Product(torch.autograd.Function):
    """a @ b with every operand of the forward and of the backward's two
    products (a, b and the output's gradient) rounded to float8."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a), _fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, dc):
        qa, qb = ctx.saved_tensors
        qdc = _fp8(dc)
        return qdc @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qdc


class Precision:
    """The products' arithmetic: ``"float32"`` exact f32 (TF32 off), or a
    control's lower precision, ``"float8"``: each operand of a product,
    and in the backward each operand of its two products, scaled by its
    largest magnitude, rounded to float8 e4m3 and multiplied in f32."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "float8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "float8":
            return _Fp8Product.apply(a, b)
        return a @ b


F32 = Precision()


def exact_f32() -> None:
    """Products in float32 as written: no TF32 anywhere (called before the
    reference runs, after the program's window)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def capacity(pairs: int, n_experts: int, factor: float) -> int:
    """Rows per expert for ``pairs`` token-expert pairs: round(pairs / E *
    factor) (Python's rounding), at least 1, and from 256 pairs on a
    multiple of 256."""
    cap = int(max(1, round(pairs / n_experts * factor)))
    return -(-cap // 256) * 256 if pairs >= 256 else cap


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
