"""Recurrent mixers: Mamba (selective SSM), mLSTM and sLSTM (xLSTM) (port of
``repro.models.ssm``).

Every weight product goes through the matmul kernel (``layers.linear`` ->
``ops.matmul``): the in/out and up/down projections, Mamba's ``x_proj`` and
``dt_w``, mLSTM's q/k/v and gate weights, and sLSTM's input weight ``w``
and its recurrent weight ``r``.  ``r`` stays 3-D, ``(nh, dh, 4 dh)`` as in
JAX, and each step takes one launch a head on head ``i``'s contiguous
block.  Each block's norm goes through the RMSNorm kernel.

What stays plain PyTorch, as it is plain ``jnp`` outside any Pallas kernel
in the reference: the scans' contractions between activations (Mamba's
``h . c``; mLSTM's ``C . q`` and ``n . q``; the chunkwise form's L x L
products and state updates), the elementwise gates, and the depthwise
causal conv.  A kernel for the scans is later work.

``chunked_scan`` keeps the reference's cost structure: a length longer
than one chunk of ``chunk`` steps runs chunk by chunk, and where autograd
records the scan each chunk runs under ``torch.utils.checkpoint``, so the
backward saves only the carries at chunk boundaries and recomputes each
chunk's steps (the reference's ``jax.checkpoint`` of the chunk body with
``nothing_saveable``).  A length within one chunk, or a scan that records
no graph (the serving path), runs one plain loop.  A length longer than one
chunk and not a multiple of it is refused, as in the reference.

Under sharding rules (DTensor inputs, ``parallel/sharding.py``) each scan
runs in a manual region (``parallel.sharding.manual``, the reference's
``_manual_scan`` on shard_map): its
inputs are redistributed to the specs of their logical axes and the scan
runs on each rank's local tensors, ``chunked_scan``'s checkpoints and
sLSTM's per-head ``ops.matmul`` launches included, so a weight's gradient
(Mamba's A, sLSTM's r) accumulates on each rank and is summed once at the
region's boundary.  The chunkwise mLSTM, which the reference leaves to
XLA's partitioner, runs in such a region too, under the recurrent form's
axes.  The annotations are the reference's; ``causal_conv`` and the gates
between them are plain PyTorch on DTensors.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate
from torch.utils.checkpoint import checkpoint

from ..kernels import ops
from ..parallel.sharding import annotate, manual, replicate_like
from . import layers as L


def _steps(xs):
    return xs.shape[0] if isinstance(xs, torch.Tensor) else xs[0].shape[0]


def _slice(xs, a, b):
    return xs[a:b] if isinstance(xs, torch.Tensor) else \
        tuple(x[a:b] for x in xs)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for sub in tree for t in _tensors(sub)]


def _loop(step_fn, carry, xs):
    """The steps of ``xs`` in order: (final carry, ys stacked)."""
    ys = []
    for t in range(_steps(xs)):
        carry, y = step_fn(carry, xs[t] if isinstance(xs, torch.Tensor)
                           else tuple(a[t] for a in xs))
        ys.append(y)
    return carry, torch.stack(ys)


def _merge_heads(y, shape):
    """y (..., nh, dh) -> ``shape`` (..., nh * dh).  A DTensor split on
    dh (``head_ff``) has its heads gathered first: a split of each head's
    dh is no split of nh * dh (which ``annotate`` then splits on
    ``inner``)."""
    if isinstance(y, DTensor):
        y = y.redistribute(y.device_mesh, tuple(
            Replicate() if p.is_shard() and p.dim >= y.ndim - 2 else p
            for p in y.placements))
    return y.reshape(shape)


def chunked_scan(step_fn, carry, xs, *, chunk: int):
    """scan(step_fn, carry, xs) over xs's leading (S,) dim (a tensor or a
    tuple of tensors); ``step_fn(carry, x_t) -> (carry, y_t)`` with ``y_t``
    a tensor and ``carry`` a tensor or a tuple of them.  Returns (final
    carry, ys (S, ...)).  S > chunk runs S / chunk chunks, each under
    ``checkpoint`` when autograd records the scan (its carry or inputs
    require grad); S <= chunk, or no graph, one loop.  Refuses S > chunk
    where chunk does not divide S, as the reference does."""
    S = _steps(xs)
    if S > chunk and S % chunk:
        raise ValueError(f"chunked_scan: {S} steps are not a whole number "
                         f"of chunks of {chunk}")
    recording = torch.is_grad_enabled() and any(
        t.requires_grad for t in _tensors((carry, xs)))
    if S <= chunk or not recording:
        return _loop(step_fn, carry, xs)
    ys = []
    for c0 in range(0, S, chunk):
        # the steps draw no random numbers and the recompute runs the same
        # ops on the same inputs: no RNG state to stash, nothing to check
        carry, y = checkpoint(_loop, step_fn, carry,
                              _slice(xs, c0, c0 + chunk),
                              use_reentrant=False, preserve_rng_state=False,
                              determinism_check="none")
        ys.append(y)
    return carry, torch.cat(ys)


# ---------------------------------------------------------------------------
# causal depthwise conv (shared by mamba/mlstm)
# ---------------------------------------------------------------------------

def causal_conv(x, w, state=None):
    """x: (B, S, C), w: (K, C) depthwise.  ``state``: (B, K-1, C) carried
    from the previous segment (decode); returns (y, new_state)."""
    B, S, C = x.shape
    K = w.shape[0]
    if state is None:
        state = replicate_like(torch.zeros((B, K - 1, C), dtype=x.dtype,
                                           device=x.device), x)
    xp = torch.cat([state, x], dim=1)
    y = torch.zeros_like(x)
    for i in range(K):
        y = y + xp[:, i:i + S, :] * w[i]
    new_state = xp[:, S:, :] if K > 1 else state
    return y, new_state


# ---------------------------------------------------------------------------
# Mamba (selective SSM)
# ---------------------------------------------------------------------------

def _mamba_inner(p, xz, cfg, conv_state, ssm_state, *, chunk):
    """xz: (B, S, 2*di) from in_proj.  Returns (y (B,S,di), conv, ssm)."""
    di = cfg.d_inner
    N = cfg.d_state
    x, z = xz[..., :di], xz[..., di:]
    x, conv_state = causal_conv(x, p["conv_w"], conv_state)
    x = F.silu(x)
    x = annotate(x, "batch", "seq", "inner")

    dbc = L.linear(x, p["x_proj"])
    dtr = di // 16
    dt = F.softplus(L.linear(dbc[..., :dtr], p["dt_w"]) + p["dt_b"])
    Bc = dbc[..., dtr:dtr + N]
    Cc = dbc[..., dtr + N:]
    A = -torch.exp(p["a_log"].float())                     # (di, N)

    # the recurrent core runs in a manual region under rules: A's gradient
    # accumulates on each rank and is summed once at the boundary
    def scan_part(A_, h0, x_s, dt_s, b_s, c_s):
        def step(h, inp):
            x_t, dt_t, b_t, c_t = inp               # (B,di),(B,di),(B,N)
            dA = torch.exp(dt_t.float()[..., None] * A_)
            dBx = (dt_t * x_t).float()[..., None] * b_t.float()[:, None, :]
            h = h * dA + dBx
            y_t = torch.einsum("bcn,bn->bc", h, c_t.float())
            return h, y_t.to(x_t.dtype)
        return chunked_scan(step, h0, (x_s, dt_s, b_s, c_s), chunk=chunk)

    xs = (x.transpose(0, 1), dt.transpose(0, 1), Bc.transpose(0, 1),
          Cc.transpose(0, 1))
    ssm_state, ys = manual(
        scan_part,
        (("inner", "state"), ("batch", "inner", "state"),
         (None, "batch", "inner"), (None, "batch", "inner"),
         (None, "batch", None), (None, "batch", None)),
        (("batch", "inner", "state"), (None, "batch", "inner")),
        (A, ssm_state) + xs)
    y = ys.transpose(0, 1) + x * p["d"]
    y = y * F.silu(z)
    return annotate(y, "batch", "seq", "inner"), conv_state, ssm_state


def mamba_block(p, x, cfg, *, chunk=256, conv_state=None, ssm_state=None):
    """Full mamba block.  Returns (out, (conv_state, ssm_state))."""
    B = x.shape[0]
    di, N = cfg.d_inner, cfg.d_state
    if ssm_state is None:
        ssm_state = replicate_like(torch.zeros(
            (B, di, N), dtype=torch.float32, device=x.device), x)
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    xz = L.linear(h, p["in_proj"])
    xz = annotate(xz, "batch", "seq", "inner")
    y, conv_state, ssm_state = _mamba_inner(
        p, xz, cfg, conv_state, ssm_state, chunk=chunk)
    out = L.linear(y, p["out_proj"])
    return annotate(out, "batch", "seq", "embed"), (conv_state, ssm_state)


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix-memory block, recurrent-chunked form)
# ---------------------------------------------------------------------------

def _mlstm_state(B, nh, dh, x):
    """The zero state on ``x``'s device (replicated where x is a
    DTensor)."""
    dev = x.device
    return tuple(replicate_like(t, x) for t in (
        torch.zeros((B, nh, dh, dh), dtype=torch.float32, device=dev),
        torch.zeros((B, nh, dh), dtype=torch.float32, device=dev),
        torch.full((B, nh), -1e30, dtype=torch.float32, device=dev)))


# the mLSTM state's logical axes: C's v-dim sharded, its k-dim and n and m
# whole (a sharded k-dim would cost a reduction every step)
_MLSTM_STATE_AXES = (("batch", None, "head_ff", None), ("batch", None, None),
                     ("batch", None))


def mlstm_block(p, x, cfg, *, chunk=128, conv_state=None, state=None,
                mode: str = "chunkwise"):
    """Returns (out, (conv_state, (C, n, m))).

    State: C (B, nh, dv, dk) matrix memory, n (B, nh, dk) normalizer,
    m (B, nh) log-space stabilizer.  ``mode``: 'chunkwise' (matmul-shaped,
    default for S>1) or 'recurrent' (the oracle; always used for S=1)."""
    B, S, D = x.shape
    di = cfg.d_inner
    nh = cfg.n_heads
    dh = di // nh
    if state is None:
        state = _mlstm_state(B, nh, dh, x)
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    xz = L.linear(h, p["up"])
    xi, z = xz[..., :di], xz[..., di:]
    xi, conv_state = causal_conv(xi, p["conv_w"], conv_state)
    xi = F.silu(xi)
    xi = annotate(xi, "batch", "seq", "inner")

    q = L.linear(xi, p["wq"]).reshape(B, S, nh, dh)
    k = L.linear(xi, p["wk"]).reshape(B, S, nh, dh)
    v = L.linear(xi, p["wv"]).reshape(B, S, nh, dh)
    # shard only v's dim (C's rows): q and k stay whole on dh, so the q.k
    # contraction and the C/n updates are rank-local
    q = annotate(q, "batch", "seq", None, None)
    k = annotate(k, "batch", "seq", None, None)
    v = annotate(v, "batch", "seq", None, "head_ff")
    gif = L.linear(xi, p["wif"]) + p["b_if"]
    ig, fg = gif[..., :nh], gif[..., nh:]
    scale = 1.0 / math.sqrt(dh)

    if mode == "chunkwise" and S > 1:
        state, y4 = manual(
            lambda *a: _mlstm_chunkwise(*a, chunk=chunk, scale=scale),
            (("batch", None, None, None), ("batch", None, None, None),
             ("batch", None, None, "head_ff"), ("batch", None, None),
             ("batch", None, None), _MLSTM_STATE_AXES),
            (_MLSTM_STATE_AXES, ("batch", None, None, "head_ff")),
            (q, k, v, ig, fg, state))
        y = annotate(_merge_heads(y4, (B, S, di)), "batch", "seq", "inner")
        y = y * F.silu(z)
        out = L.linear(y, p["down"])
        return annotate(out, "batch", "seq", "embed"), (conv_state, state)

    def step(carry, inp):
        C, n, m = carry
        q_t, k_t, v_t, i_t, f_t = inp
        i_t = i_t.float()
        logf = -F.softplus(-f_t.float())
        m_new = torch.maximum(logf + m, i_t)
        fe = torch.exp(logf + m - m_new)
        ie = torch.exp(i_t - m_new)
        kf = k_t.float() * scale
        C = C * fe[..., None, None] + \
            ie[..., None, None] * v_t.float()[..., None] * kf[:, :, None, :]
        n = n * fe[..., None] + ie[..., None] * kf
        qy = torch.einsum("bhvk,bhk->bhv", C, q_t.float())
        denom = torch.maximum(
            torch.abs(torch.einsum("bhk,bhk->bh", n, q_t.float())),
            torch.exp(-m_new))[..., None]
        return (C, n, m_new), (qy / denom).to(q_t.dtype)

    def scan_part(st, q_s, k_s, v_s, i_s, f_s):
        return chunked_scan(step, st, (q_s, k_s, v_s, i_s, f_s),
                            chunk=chunk)

    xs = (q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1),
          ig.transpose(0, 1), fg.transpose(0, 1))
    state, ys = manual(
        scan_part,
        (_MLSTM_STATE_AXES,
         (None, "batch", None, None), (None, "batch", None, None),
         (None, "batch", None, "head_ff"),
         (None, "batch", None), (None, "batch", None)),
        (_MLSTM_STATE_AXES, (None, "batch", None, "head_ff")),
        (state,) + xs)
    y = annotate(_merge_heads(ys.transpose(0, 1), (B, S, di)), "batch",
                 "seq", "inner")
    y = y * F.silu(z)
    out = L.linear(y, p["down"])
    return annotate(out, "batch", "seq", "embed"), (conv_state, state)


def _mlstm_chunkwise(q, k, v, ig, fg, state, *, chunk: int, scale: float):
    """Chunkwise-parallel mLSTM, an exact reformulation of the recurrent
    form (the reference's docstring derives it): with a_t = cumsum(logsig
    f), b_s = i_s - a_s and stabilizer m_t = a_t + mm_t where mm_t =
    max(m_in, cummax b), every intra-chunk weight is exp(b_s - mm_t) (q_t .
    k_s).  The chunk length L is the largest divisor of S not above
    ``chunk``.

    q,k,v: (B,S,nh,dh); ig,fg: (B,S,nh); state=(C,n,m) as in mlstm_block.
    Returns (state, y (B,S,nh,dh)).
    """
    B, S, nh, dh = q.shape
    L_ = min(chunk, S)
    while S % L_:
        L_ -= 1
    nc = S // L_

    def to_chunks(x):
        return x.reshape((B, nc, L_) + x.shape[2:]).transpose(0, 1)

    qc, kc, vc = to_chunks(q), to_chunks(k), to_chunks(v)
    ic, fc = to_chunks(ig.float()), to_chunks(fg.float())
    mask = torch.tril(torch.ones((L_, L_), dtype=torch.bool,
                                 device=q.device))
    C, n, m_in = state
    ys = []
    for c in range(nc):
        q_, k_, v_, i_, f_ = qc[c], kc[c], vc[c], ic[c], fc[c]
        logf = -F.softplus(-f_)                         # (B,L,h)
        a = torch.cumsum(logf, dim=1)
        b = i_ - a
        mm = torch.maximum(torch.cummax(b, dim=1).values, m_in[:, None])
        qf = q_.float()
        kf = k_.float() * scale
        vf = v_.float()

        sqk = torch.einsum("blhd,bshd->bhls", qf, kf)            # (B,h,L,L)
        b_bhs = b.transpose(1, 2)                                 # (B,h,S)
        mm_bht = mm.transpose(1, 2)                               # (B,h,T)
        # dec[b,h,t,s] = exp(b_s - mm_t); mask s<=t
        dec = torch.exp(b_bhs[:, :, None, :] - mm_bht[:, :, :, None])
        Wt = torch.where(mask, sqk * dec, 0.0)
        intra = torch.einsum("bhts,bshd->bthd", Wt, vf)

        inter_scale = torch.exp(m_in[:, None] - mm)              # (B,L,h)
        inter = torch.einsum("bhvk,blhk->blhv", C, qf) * \
            inter_scale[..., None]

        Nw = torch.where(mask, dec, 0.0)                         # (B,h,t,s)
        n_t = torch.einsum("bhts,bshk->bthk", Nw, kf) + \
            n[:, None] * inter_scale[..., None]
        qn = torch.einsum("blhk,blhk->blh", qf, n_t)
        m_t = a + mm                                             # absolute
        denom = torch.maximum(torch.abs(qn), torch.exp(-m_t))[..., None]
        ys.append(((inter + intra) / denom).to(q_.dtype))

        mm_L = mm[:, -1]
        wS = torch.exp(b - mm_L[:, None])                        # (B,L,h)
        C_out = torch.einsum("blh,blhv,blhk->bhvk", wS, vf, kf) + \
            torch.exp(m_in - mm_L)[..., None, None] * C
        n = torch.einsum("blh,blhk->bhk", wS, kf) + \
            torch.exp(m_in - mm_L)[..., None] * n
        C, m_in = C_out, a[:, -1] + mm_L
    y = torch.stack(ys, dim=1).reshape(B, S, nh, v.shape[-1])
    return (C, n, m_in), y


# ---------------------------------------------------------------------------
# sLSTM (xLSTM scalar-memory block)
# ---------------------------------------------------------------------------

def slstm_block(p, x, cfg, *, chunk=128, state=None):
    """Strictly sequential scalar-memory LSTM with exponential gating and
    per-head block-diagonal recurrence.  Returns (out, state);
    state = (c, n, h, m) each (B, D) [(B, nh) for m].

    The recurrent term is head-major, as in the reference: head i's
    ``h_i . r[i]`` fills columns [4 dh i, 4 dh (i + 1)) of the (B, 4D)
    gate pre-activations, which are then split into z, i, f, o over the
    flattened 4D.  With 4 heads each gate's recurrent term comes from one
    head's state only (z from head 0, i from 1, f from 2, o from 3)."""
    B, S, D = x.shape
    nh = cfg.n_heads
    dh = D // nh
    di = cfg.d_inner
    if state is None:
        z = torch.zeros((B, D), dtype=torch.float32, device=x.device)
        state = tuple(replicate_like(t, x) for t in (
            z, z.clone(), z.clone(),
            torch.full((B, nh), -1e30, dtype=torch.float32,
                       device=x.device)))
    xh = L.rms_norm(x, p["ln"], cfg.norm_eps)
    wx = L.linear(xh, p["w"]) + p["b"]                     # (B,S,4D)

    def step(carry, wx_t, r):
        c, n, h, m = carry
        Bt = h.shape[0]
        hh = h.reshape(Bt, nh, dh)
        rg = torch.stack([ops.matmul(hh[:, i], r[i].to(hh.dtype))
                          for i in range(nh)], dim=1).reshape(Bt, 4 * D)
        g = wx_t.float() + rg
        zt = torch.tanh(g[..., :D])
        it = g[..., D:2 * D].reshape(Bt, nh, dh).mean(-1)
        ft = g[..., 2 * D:3 * D].reshape(Bt, nh, dh).mean(-1)
        ot = torch.sigmoid(g[..., 3 * D:])
        logf = -F.softplus(-ft)
        m_new = torch.maximum(logf + m, it)
        fe = torch.exp(logf + m - m_new)[..., None].expand(Bt, nh, dh) \
            .reshape(Bt, D)
        ie = torch.exp(it - m_new)[..., None].expand(Bt, nh, dh) \
            .reshape(Bt, D)
        c_new = fe * c + ie * zt
        n_new = fe * n + ie
        h_new = ot * c_new / torch.clamp(n_new, min=1.0)
        return (c_new, n_new, h_new, m_new), h_new.to(wx_t.dtype)

    def scan_part(r_, st, wx_s):
        return chunked_scan(lambda c, w: step(c, w, r_), st, wx_s,
                            chunk=chunk)

    st_ax = (("batch", None),) * 4
    state, ys = manual(
        scan_part, ((None, None, None), st_ax, (None, "batch", None)),
        (st_ax, (None, "batch", None)),
        (p["r"], state, wx.transpose(0, 1)))
    h_seq = ys.transpose(0, 1)
    # per-block projection FFN (d_ff=0 archs carry their own up/down)
    u = L.linear(h_seq, p["up"])                           # (B,S,2*di) GLU
    u = annotate(u, "batch", "seq", "inner")
    out = L.linear(F.silu(u[..., :di]) * u[..., di:], p["down"])
    return annotate(out, "batch", "seq", "embed"), state
