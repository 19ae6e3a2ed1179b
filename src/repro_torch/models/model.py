"""Model assembly for every family: parameters, forward, prefill, decode
(port of ``repro.models.model``).

A configuration's ``pattern`` and ``ffn_pattern`` are one period of layer
kinds (mixers ``attn``, ``mla``, ``mamba``, ``mlstm``, ``slstm``; FFNs
``dense``, ``moe``, ``none``), repeated ``n_periods`` times.  Parameters
are a plain dict of tensors, as in JAX: one group per position of the
period, ``pos0``-``pos{period-1}``, each weight stacked over periods
(leading ``n_periods`` dim; attention and MLA projections 2-D, see
``layers.py``).  The ``lax.scan`` over periods is a loop over periods,
then positions.  The cache keeps the JAX structure, one entry per
position, each leaf with a leading ``n_periods`` dim and batch at dim 1,
updated in place: ``(k, v)`` of shape ``(P, B, s_max, KVH, dh)`` under
attention; MLA's latent ``(c_kv, k_rope)``; Mamba's ``(conv, ssm)``;
mLSTM's ``(conv, (C, n, m))``; sLSTM's ``(c, n, h, m)``.  Conv states are
in the compute dtype, SSM states in f32.

The two frontend stubs are the reference's.  With ``n_codebooks`` (musicgen)
tokens are ``(B, S, ncb)``, the embedding ``(ncb, V, D)`` sums one gather a
codebook, and the head ``(ncb, D, V)`` gives ``(B, S, ncb, V)`` logits, one
matmul launch a codebook on its contiguous ``(D, V)`` block.  With
``n_patches`` (internvl2) a batch may carry ``"patches"`` ``(B, P, D)``,
which go in front of the token embeddings: positions run over P + S, and
the cache and ``prefill``'s t count the prefix.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..configs.base import ArchConfig
from ..device import DeviceLike, resolve_device
from ..parallel.sharding import (annotate, current_rules, local_shape,
                                 on_shards, pick_rule, placements,
                                 replicate_like, rows_at_rule, take_rule,
                                 write_block)
from . import layers as L
from . import moe as M
from . import remat as R
from . import ssm as S

Params = Dict[str, Dict[str, torch.Tensor]]


@dataclass(frozen=True)
class ModelKnobs:
    """Step-function choices (the JAX ``ModelKnobs`` fields that the port's
    paths read, with JAX's defaults).  ``remat`` checkpoints each period
    of the stack where autograd records it (``remat.py``); the tuning
    loop reads it too, ``tune/lm_study.py``."""

    kv_chunk: int = 1024          # flash-attention KV chunk
    moe_dispatch: str = "a2a"     # 'a2a' (one device: 'sort'), 'sort', 'dense'
    ssm_chunk: int = 256          # mamba/xlstm chunk length
    remat: str = "full"           # 'none' | 'full' | 'dots'
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    logits_f32: bool = True


# the layer kinds the port runs, in any period
MIXERS = ("attn", "mla", "mamba", "mlstm", "slstm")
FFNS = ("dense", "moe", "none")
# the mixers whose cache is a sequence (padded to s_max, read at kv_positions)
ATTENTION = ("attn", "mla")


def check_supported(cfg: ArchConfig) -> None:
    if set(cfg.pattern) - set(MIXERS) or set(cfg.ffn_pattern) - set(FFNS):
        raise NotImplementedError(
            f"{cfg.name}: the port runs periods of the mixers {MIXERS} with "
            f"the FFNs {FFNS}; got {cfg.pattern}/{cfg.ffn_pattern}")


def _kind_spec(cfg: ArchConfig, kind: str) -> Dict[str, Tuple[tuple, float]]:
    """One mixer's (shape, fan_in) per parameter, unstacked (JAX
    ``_kind_params`` with the fan-ins there; fan 0 = zeros).  The JAX init
    zeroes every name ending in ``_b`` (meant for biases), which takes in
    MLA's ``wq_b``, ``wk_b`` and ``wv_b`` and makes its block's output
    zero; the port draws them from their fan-ins, so the path computes
    something."""
    D, H, di = cfg.d_model, cfg.n_heads, cfg.d_inner
    out = {"ln": ((D,), 0.0)}
    if kind == "attn":
        HD, KD = H * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
        out.update({"wq": ((D, HD), D), "wk": ((D, KD), D),
                    "wv": ((D, KD), D), "wo": ((HD, D), HD)})
    elif kind == "mla":
        m = cfg.mla
        out.update({"wq_a": ((D, m.q_lora), D),
                    "q_ln": ((m.q_lora,), 0.0),
                    "wq_b": ((m.q_lora, H * (m.d_nope + m.d_rope)),
                             m.q_lora),
                    "wkv_a": ((D, m.kv_lora + m.d_rope), D),
                    "kv_ln": ((m.kv_lora,), 0.0),
                    "wk_b": ((m.kv_lora, H * m.d_nope), m.kv_lora),
                    "wv_b": ((m.kv_lora, H * m.d_v), m.kv_lora),
                    "wo": ((H * m.d_v, D), H * m.d_v)})
    elif kind == "mamba":
        N, dtr = cfg.d_state, di // 16
        out.update({"in_proj": ((D, 2 * di), D),
                    "conv_w": ((cfg.d_conv, di), cfg.d_conv),
                    "x_proj": ((di, dtr + 2 * N), di),
                    "dt_w": ((dtr, di), dtr),
                    "dt_b": ((di,), 0.0),
                    "a_log": ((di, N), 0.0),
                    "d": ((di,), 0.0),
                    "out_proj": ((di, D), di)})
    elif kind == "mlstm":
        out.update({"up": ((D, 2 * di), D),
                    "conv_w": ((cfg.d_conv, di), cfg.d_conv),
                    "wq": ((di, di), di), "wk": ((di, di), di),
                    "wv": ((di, di), di),
                    "wif": ((di, 2 * H), di),
                    "b_if": ((2 * H,), 0.0),
                    "down": ((di, D), di)})
    else:   # slstm
        dh = D // H
        out.update({"w": ((D, 4 * D), D),
                    "r": ((H, dh, 4 * dh), dh),
                    "b": ((4 * D,), 0.0),
                    "up": ((D, 2 * di), D),
                    "down": ((di, D), di)})
    return out


def _ffn_spec(cfg: ArchConfig, fk: str) -> Dict[str, Tuple[tuple, float]]:
    """One FFN's (shape, fan_in) per parameter, unstacked (JAX
    ``_ffn_params``; ``none`` has none)."""
    D = cfg.d_model
    if fk == "none":
        return {}
    out = {"ln": ((D,), 0.0)}
    if fk == "dense":
        F = cfg.d_ff
        out.update({"w_gate": ((D, F), D), "w_up": ((D, F), D),
                    "w_down": ((F, D), F)})
        return out
    e = cfg.moe
    E, Fe = e.n_experts, e.d_ff_expert
    out.update({"router": ((D, E), D),
                "w_gate": ((E, D, Fe), D),
                "w_up": ((E, D, Fe), D),
                "w_down": ((E, Fe, D), Fe)})
    if e.n_shared:
        Fs = e.n_shared * Fe
        out.update({"sh_gate": ((D, Fs), D), "sh_up": ((D, Fs), D),
                    "sh_down": ((Fs, D), Fs)})
    return out


def spec_tree(cfg: ArchConfig) -> Dict[str, Dict[str, Tuple[tuple, float]]]:
    """(shape, fan_in) per parameter; fan 0 = zeros, -1 = embedding init.
    Block weights are stacked over periods: ``pos{i}`` holds position
    ``i``'s mixer (``mix_*``) and FFN (``ffn_*``) weights with a leading
    ``n_periods`` dim."""
    check_supported(cfg)
    D, V, P, ncb = cfg.d_model, cfg.vocab, cfg.n_periods, cfg.n_codebooks
    books = (ncb,) if ncb else ()
    tree = {"embed": {"tok": (books + (V, D), -1)},
            "final": {"ln": ((D,), 0.0)}}
    for i, (kind, fk) in enumerate(zip(cfg.pattern, cfg.ffn_pattern)):
        pos = {}
        for pre, spec in (("mix_", _kind_spec(cfg, kind)),
                          ("ffn_", _ffn_spec(cfg, fk))):
            for nm, (shape, fan) in spec.items():
                pos[pre + nm] = ((P,) + shape, fan)
        tree[f"pos{i}"] = pos
    if not cfg.tie_embeddings:
        tree["head"] = {"w": (books + (D, V), D)}
    return tree


def _kind_axes(cfg: ArchConfig, kind: str) -> Dict[str, Tuple[tuple, tuple]]:
    """One mixer's (JAX shape, logical axes) per parameter, unstacked: the
    reference's ``_kind_params``, whose attention and MLA projections are
    3-D where the port's are 2-D."""
    D, dh = cfg.d_model, cfg.head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    di = cfg.d_inner
    out = {"ln": ((D,), ("embed",))}
    if kind == "attn":
        out.update({
            "wq": ((D, H, dh), ("fsdp_embed", "heads_w", None)),
            "wk": ((D, KV, dh), ("fsdp_embed", "heads_w", None)),
            "wv": ((D, KV, dh), ("fsdp_embed", "heads_w", None)),
            "wo": ((H, dh, D), ("heads_w", None, "fsdp_embed")),
        })
    elif kind == "mla":
        m = cfg.mla
        out.update({
            "wq_a": ((D, m.q_lora), ("fsdp_embed", "lora")),
            "q_ln": ((m.q_lora,), ("lora",)),
            "wq_b": ((m.q_lora, H, m.d_nope + m.d_rope),
                     ("lora", "heads_w", None)),
            "wkv_a": ((D, m.kv_lora + m.d_rope), ("fsdp_embed", "lora")),
            "kv_ln": ((m.kv_lora,), ("lora",)),
            "wk_b": ((m.kv_lora, H, m.d_nope), ("lora", "heads_w", None)),
            "wv_b": ((m.kv_lora, H, m.d_v), ("lora", "heads_w", None)),
            "wo": ((H, m.d_v, D), ("heads_w", None, "fsdp_embed")),
        })
    elif kind == "mamba":
        N, dtr = cfg.d_state, di // 16
        out.update({
            "in_proj": ((D, 2 * di), ("fsdp_embed", "inner")),
            "conv_w": ((cfg.d_conv, di), (None, "inner")),
            "x_proj": ((di, dtr + 2 * N), ("inner", None)),
            "dt_w": ((dtr, di), (None, "inner")),
            "dt_b": ((di,), ("inner",)),
            "a_log": ((di, N), ("inner", "state")),
            "d": ((di,), ("inner",)),
            "out_proj": ((di, D), ("inner", "fsdp_embed")),
        })
    elif kind == "mlstm":
        out.update({
            "up": ((D, 2 * di), ("fsdp_embed", "inner")),
            "conv_w": ((cfg.d_conv, di), (None, "inner")),
            "wq": ((di, di), ("inner", None)),
            "wk": ((di, di), ("inner", None)),
            "wv": ((di, di), ("inner", None)),
            "wif": ((di, 2 * H), ("inner", None)),
            "b_if": ((2 * H,), (None,)),
            "down": ((di, D), ("inner", "fsdp_embed")),
        })
    else:   # slstm
        dh_s = D // H
        out.update({
            "w": ((D, 4 * D), ("fsdp_embed", None)),
            "r": ((H, dh_s, 4 * dh_s), (None, None, None)),
            "b": ((4 * D,), (None,)),
            "up": ((D, 2 * di), ("fsdp_embed", "inner")),
            "down": ((di, D), ("inner", "fsdp_embed")),
        })
    return out


def _ffn_axes(cfg: ArchConfig, fk: str) -> Dict[str, Tuple[tuple, tuple]]:
    """One FFN's (JAX shape, logical axes) per parameter (the reference's
    ``_ffn_params``)."""
    D = cfg.d_model
    if fk == "none":
        return {}
    out = {"ln": ((D,), ("embed",))}
    if fk == "dense":
        F_ = cfg.d_ff
        out.update({"w_gate": ((D, F_), ("fsdp_embed", "ffn")),
                    "w_up": ((D, F_), ("fsdp_embed", "ffn")),
                    "w_down": ((F_, D), ("ffn", "fsdp_embed"))})
        return out
    e = cfg.moe
    E, Fe = e.n_experts, e.d_ff_expert
    out.update({"router": ((D, E), ("fsdp_embed", None)),
                "w_gate": ((E, D, Fe), ("expert", "fsdp_embed", "ffn")),
                "w_up": ((E, D, Fe), ("expert", "fsdp_embed", "ffn")),
                "w_down": ((E, Fe, D), ("expert", "ffn", "fsdp_embed"))})
    if e.n_shared:
        Fs = e.n_shared * Fe
        out.update({"sh_gate": ((D, Fs), ("fsdp_embed", "ffn")),
                    "sh_up": ((D, Fs), ("fsdp_embed", "ffn")),
                    "sh_down": ((Fs, D), ("ffn", "fsdp_embed"))})
    return out


def jax_axes_tree(cfg: ArchConfig) -> Dict[str, Dict[str, Tuple[tuple,
                                                                tuple]]]:
    """(JAX shape, logical axes) per port parameter: the reference's
    ``_spec_tree`` without the fan-ins.  Block weights carry the leading
    ``n_periods`` dim, logical axis ``"layers"`` (in no rule table: always
    replicated)."""
    check_supported(cfg)
    D, V, P, ncb = cfg.d_model, cfg.vocab, cfg.n_periods, cfg.n_codebooks
    books, book_ax = ((ncb,), (None,)) if ncb else ((), ())
    tree = {"embed": {"tok": (books + (V, D),
                              book_ax + ("vocab", "fsdp_embed"))},
            "final": {"ln": ((D,), ("embed",))}}
    for i, (kind, fk) in enumerate(zip(cfg.pattern, cfg.ffn_pattern)):
        pos = {}
        for pre, spec in (("mix_", _kind_axes(cfg, kind)),
                          ("ffn_", _ffn_axes(cfg, fk))):
            for nm, (shape, axes) in spec.items():
                pos[pre + nm] = ((P,) + shape, ("layers",) + axes)
        tree[f"pos{i}"] = pos
    if not cfg.tie_embeddings:
        tree["head"] = {"w": (books + (D, V),
                              book_ax + ("fsdp_embed", "vocab"))}
    return tree


def param_axes(cfg: ArchConfig) -> Dict[str, Dict[str, tuple]]:
    """The reference's logical axes of every weight, one per dim of its
    JAX tensor (``Model.param_shapes``)."""
    return {g: {nm: axes for nm, (_, axes) in sub.items()}
            for g, sub in jax_axes_tree(cfg).items()}


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device: DeviceLike = None,
                dtype: torch.dtype = torch.float32) -> Params:
    """Random weights with the JAX init's distributions: norms and biases
    zero (scale 1 + w = 1), embeddings N(0, 0.02^2), projections N(0,
    1/fan_in); Mamba's skip weight ``d`` ones, ``a_log`` log(1..N) on every
    channel (A = -[1..N], S4D-real) and ``dt_b`` log(expm1(0.01)).  Drawn
    on the generator's device (a CPU generator gives the same weights on
    every device), then moved to ``device``."""
    dev = resolve_device(device)
    params: Params = {}
    for g, sub in sorted(spec_tree(cfg).items()):
        for nm, (shape, fan) in sorted(sub.items()):
            if nm.endswith("a_log"):
                w = torch.log(torch.arange(1, shape[-1] + 1,
                                           dtype=torch.float32)) \
                    .expand(shape).contiguous()
            elif nm.endswith("dt_b"):
                w = torch.full(shape, math.log(math.expm1(0.01)))
            elif nm.endswith("mix_d"):
                w = torch.ones(shape)
            elif fan == 0.0:
                w = torch.zeros(shape)
            else:
                std = 0.02 if fan == -1 else 1.0 / math.sqrt(max(fan, 1))
                w = torch.randn(shape, generator=generator,
                                device=generator.device) * std
            params.setdefault(g, {})[nm] = w.to(device=dev, dtype=dtype)
    return params


def _take(tok, table):
    """``F.embedding``; on DTensors under ``parallel.sharding.take_rule``."""
    if isinstance(tok, DTensor) or isinstance(table, DTensor):
        return on_shards(F.embedding, take_rule, tok, table)
    return F.embedding(tok, table)


def _pick_local(x, idx):
    return torch.gather(x, -1, idx[..., None])[..., 0]


def _pick(x, idx):
    """x's entry at ``idx`` along its last dim, row by row; on DTensors under
    ``parallel.sharding.pick_rule``."""
    if isinstance(x, DTensor):
        return on_shards(_pick_local, pick_rule, x, idx)
    return _pick_local(x, idx)


def _rows_at_local(x, at):
    return x[torch.arange(x.shape[0], device=x.device), at][:, None]


def _rows_at(x, at):
    """x (B, S, ...) at position ``at[b]`` of row b: (B, 1, ...); on
    DTensors under ``parallel.sharding.rows_at_rule``."""
    if isinstance(x, DTensor):
        return on_shards(_rows_at_local, rows_at_rule, x,
                         replicate_like(at, x))
    return _rows_at_local(x, at)


@dataclass(frozen=True)
class _Leaf:
    """A cache leaf to make: its shape, dtype and fill."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    fill: float


def map_cache(fn: Callable, *trees):
    """``fn`` over the leaves of cache trees of one structure (nested
    tuples of tensors); returns the results in that structure."""
    if isinstance(trees[0], torch.Tensor):
        return fn(*trees)
    return tuple(map_cache(fn, *sub) for sub in zip(*trees))


class Model:
    def __init__(self, cfg: ArchConfig, knobs: ModelKnobs = ModelKnobs(),
                 device: DeviceLike = None):
        check_supported(cfg)
        self.cfg = cfg
        self.knobs = knobs
        self.device = resolve_device(device)

    def init(self, generator: torch.Generator) -> Params:
        return init_params(self.cfg, generator, self.device,
                           self.knobs.param_dtype)

    def param_axes(self):
        return param_axes(self.cfg)

    def param_shapes(self):
        """The JAX shape of every weight, which ``param_axes`` describes
        (the port's own shapes: ``spec_tree``)."""
        return {g: {nm: torch.Size(shape) for nm, (shape, _) in sub.items()}
                for g, sub in jax_axes_tree(self.cfg).items()}

    # -- embedding / head -----------------------------------------------------

    def _embed(self, params, batch):
        """The token gather (``F.embedding``, whose backward sums each
        row's gradients in a fixed order on the CPU and the card alike),
        codebooks summed, a patch prefix in front."""
        cd = self.knobs.compute_dtype
        table = params["embed"]["tok"].to(cd)
        tok = batch["tokens"].long()
        if self.cfg.n_codebooks:
            # (B, S, ncb) tokens: the sum of the per-codebook embeddings
            x = sum(_take(tok[..., c], t)
                    for c, t in enumerate(table.unbind(0)))
        else:
            x = _take(tok, table)
        if self.cfg.n_patches and "patches" in batch:
            x = torch.cat([batch["patches"].to(cd), x], dim=1)
        return annotate(x, "batch", "seq", "embed")

    def _head(self, params, x):
        if self.knobs.logits_f32:
            x = x.float()
        if self.cfg.n_codebooks:   # bsd,cdv->bscv: a launch a codebook
            w = params["head"]["w"].to(x.dtype)
            logits = torch.stack([L.linear(x, w[c])
                                  for c in range(w.shape[0])], dim=2)
            return annotate(logits, "batch", "seq", None, "vocab")
        if "head" in params:
            w = params["head"]["w"].to(x.dtype)
        else:   # tied: a transposed view, read in place by the kernel
            w = params["embed"]["tok"].to(x.dtype).T
        return annotate(L.linear(x, w), "batch", "seq", "vocab")

    # -- layers ---------------------------------------------------------------

    def _layers(self, params, n_periods: Optional[int] = None
                ) -> Iterator[Tuple[int, int, dict, dict]]:
        """Per layer, periods then positions: (period j, position i, mixer
        params, ffn params), views of position i's stacks at period j.
        Each stack is unbound once, so that a backward stacks its
        per-layer gradients in one pass (a view taken a layer at a time
        would fill and add a zero tensor the size of the whole stack for
        each layer).  ``n_periods``: the stacks' length (default the
        configuration's; a pipeline stage holds fewer)."""
        views = [{k: v.unbind(0) for k, v in params[f"pos{i}"].items()}
                 for i in range(self.cfg.period)]
        for j in range(n_periods or self.cfg.n_periods):
            for i, stack in enumerate(views):
                yield (j, i,
                       {k[4:]: v[j] for k, v in stack.items()
                        if k.startswith("mix_")},
                       {k[4:]: v[j] for k, v in stack.items()
                        if k.startswith("ffn_")})

    def _ffn(self, i, pf, x):
        """x plus position i's FFN (none: x)."""
        fk = self.cfg.ffn_pattern[i]
        if fk == "moe":
            return x + M.moe_ffn(pf, x, self.cfg,
                                 dispatch=self.knobs.moe_dispatch)
        if fk == "dense":
            return x + L.ffn_block(pf, x, self.cfg)
        return x

    def _block(self, i, p, pf, x, positions):
        """One layer at position i over the whole sequence: (x, its cache
        entry)."""
        cfg, kn = self.cfg, self.knobs
        kind = cfg.pattern[i]
        if kind == "attn":
            h, c = L.attn_block(p, x, cfg, positions=positions,
                                kv_chunk=kn.kv_chunk)
        elif kind == "mla":
            h, c = L.mla_block(p, x, cfg, positions=positions,
                               kv_chunk=kn.kv_chunk)
        elif kind == "mamba":
            h, c = S.mamba_block(p, x, cfg, chunk=kn.ssm_chunk)
        elif kind == "mlstm":
            h, c = S.mlstm_block(p, x, cfg, chunk=kn.ssm_chunk)
        else:
            h, c = S.slstm_block(p, x, cfg, chunk=kn.ssm_chunk)
        return self._ffn(i, pf, x + h), c

    def _block_decode(self, i, p, pf, x, c, t, kv_positions):
        """One layer at position i for one new token; ``c`` is its cache
        entry (views at its period), written in place.  The SSM kinds run
        at chunk 1 from their carried state and ignore ``t``."""
        cfg = self.cfg
        kind = cfg.pattern[i]
        if kind in ATTENTION:
            decode = L.attn_decode if kind == "attn" else L.mla_decode
            h, _ = decode(p, x, c, cfg, t=t, kv_positions=kv_positions)
        else:
            if kind == "mamba":
                h, new = S.mamba_block(p, x, cfg, chunk=1, conv_state=c[0],
                                       ssm_state=c[1])
            elif kind == "mlstm":
                h, new = S.mlstm_block(p, x, cfg, chunk=1, conv_state=c[0],
                                       state=c[1])
            else:
                h, new = S.slstm_block(p, x, cfg, chunk=1, state=c)
            map_cache(lambda old, nw: write_block(old, nw, (0,) * old.ndim),
                      c, new)
        return self._ffn(i, pf, x + h)

    def _period(self, x, layers, positions, caches=None):
        """One period's layers, (position, mixer params, ffn params) each,
        over the whole sequence; their cache entries go to ``caches``."""
        for i, p, pf in layers:
            x, c = self._block(i, p, pf, x, positions)
            x = annotate(x, "batch", "seq", "embed")
            if caches is not None:
                caches.append(c)
        return x

    def _backbone(self, params, batch, *, with_cache=False):
        """Embedding, the periods, the final norm.  Without a cache each
        period runs under ``knobs.remat`` (``remat.run``: checkpointed
        only where autograd records it)."""
        x = self._embed(params, batch)
        caches = [] if with_cache else None
        x = self._periods(params, x, caches=caches)
        x = L.rms_norm(x, params["final"]["ln"], self.cfg.norm_eps)
        return x, caches

    def _periods(self, params, x, n_periods: Optional[int] = None,
                 caches=None):
        """The stacks' periods over x (the reference's scan of
        ``_period_body_fwd``); without a cache each period runs under
        ``knobs.remat``."""
        positions = torch.arange(x.shape[1], device=x.device)
        for _, period in itertools.groupby(self._layers(params, n_periods),
                                           key=lambda layer: layer[0]):
            layers = [(i, p, pf) for _, i, p, pf in period]
            if caches is not None:
                x = self._period(x, layers, positions, caches)
            else:
                x = R.run(self.knobs.remat, self._period, x, layers,
                          positions)
        return x

    def forward(self, params, batch, *, with_cache=False):
        x, caches = self._backbone(params, batch, with_cache=with_cache)
        logits = self._head(params, x)
        return (logits, caches) if with_cache else logits

    def loss(self, params, batch):
        """The mean over positions of logsumexp(logits) - logits[label]
        (f32 logits with ``logits_f32``); with a patch prefix only the
        text tail ``logits[:, -S_labels:]``; with codebooks logits (B, S,
        ncb, V) against labels (B, S, ncb).  A gather takes the
        reference's one-hot product."""
        return self._ce(self.forward(params, batch), batch["labels"])

    def _ce(self, logits, labels):
        """``loss``'s mean cross-entropy of the logits against the labels."""
        labels = labels.long()
        if self.cfg.n_patches:
            # labels align with the text tail of the concatenated sequence
            logits = logits[:, -labels.shape[1]:]
        lse = torch.logsumexp(logits, dim=-1)
        return torch.mean(lse - _pick(logits, labels))

    # -- prefill / decode -----------------------------------------------------

    def cache_axes(self):
        """Logical axes of every cache leaf (the ``init_cache`` structure):
        attention's K/V over (batch, kv_seq, kv_heads), MLA's latent over
        (batch, kv_seq, lora), the SSM states over batch and their inner
        width; mLSTM's C has its v-dim sharded (``head_ff``) and n and m
        whole, as the scan's region holds them."""
        axes = []
        for kind in self.cfg.pattern:
            if kind == "attn":
                a = ("layers", "batch", "kv_seq", "kv_heads", None)
                axes.append((a, a))
            elif kind == "mla":
                axes.append((("layers", "batch", "kv_seq", "lora"),
                             ("layers", "batch", "kv_seq", None)))
            elif kind == "mamba":
                axes.append((("layers", "batch", None, "inner"),
                             ("layers", "batch", "inner", "state")))
            elif kind == "mlstm":
                axes.append((("layers", "batch", None, "inner"),
                             (("layers", "batch", None, "head_ff", None),
                              ("layers", "batch", None, None),
                              ("layers", "batch", None))))
            else:   # slstm
                axes.append((("layers", "batch", None),) * 4)
        return tuple(axes)

    def init_cache(self, batch_size: int, s_max: int, rules=None):
        """The zero cache (mLSTM's and sLSTM's m at -1e30).  With ``rules``
        (a mesh), each leaf is a DTensor placed by the spec of its
        ``cache_axes`` entry, and each rank allocates only its own shard:
        no rank holds the whole cache (the reference's decode cell places
        its cache so, ``launch/cells.py``)."""
        cfg = self.cfg
        f32 = torch.float32

        def full(*shape, dtype=self.knobs.compute_dtype, fill=0.0):
            return _Leaf((cfg.n_periods, batch_size) + shape, dtype, fill)

        def make(leaf, ax):
            if isinstance(leaf, tuple):
                return tuple(make(a, b) for a, b in zip(leaf, ax))
            if rules is None or rules.mesh is None:
                return torch.full(leaf.shape, leaf.fill, dtype=leaf.dtype,
                                  device=self.device)
            pl = placements(rules.spec(*ax, dims=leaf.shape), rules.mesh)
            return DTensor.from_local(
                torch.full(local_shape(leaf.shape, rules.mesh, pl),
                           leaf.fill, dtype=leaf.dtype,
                           device=self.device), rules.mesh, pl,
                run_check=False)

        di, nh, D = cfg.d_inner, cfg.n_heads, cfg.d_model
        out = []
        for kind in cfg.pattern:
            if kind == "attn":
                kv = (s_max, cfg.n_kv_heads, cfg.head_dim)
                out.append((full(*kv), full(*kv)))
            elif kind == "mla":
                out.append((full(s_max, cfg.mla.kv_lora),
                            full(s_max, cfg.mla.d_rope)))
            elif kind == "mamba":
                out.append((full(cfg.d_conv - 1, di),
                            full(di, cfg.d_state, dtype=f32)))
            elif kind == "mlstm":
                dh = di // nh
                out.append((full(cfg.d_conv - 1, di),
                            (full(nh, dh, dh, dtype=f32),
                             full(nh, dh, dtype=f32),
                             full(nh, dtype=f32, fill=-1e30))))
            else:   # slstm
                out.append((full(D, dtype=f32), full(D, dtype=f32),
                            full(D, dtype=f32),
                            full(nh, dtype=f32, fill=-1e30)))
        return make(tuple(out), self.cache_axes())

    def prefill(self, params, batch, s_max: int, logits_at=None):
        """Run the full prompt, build an s_max-capacity cache.

        ``logits_at``: optional (B,) positions of each row's true prompt end
        (right-padded batches) in the sequence the layers see, a patch
        prefix's P positions included; default = last position.  Returns
        (logits (B, V) [(B, ncb, V) with codebooks] at those positions,
        cache, t = P + prompt_len).  The pad
        positions' K/V (MLA: latents) stay in the cache, and decode masks
        them; an SSM's state is the one after the whole padded prompt, as
        in the reference."""
        x, caches = self._backbone(params, batch, with_cache=True)
        B, S_ = x.shape[0], x.shape[1]
        if logits_at is None:
            logits_at = torch.full((B,), S_ - 1, device=x.device)
        logits = self._head(params, _rows_at(x, logits_at.long()))[:, 0]
        cache = self.init_cache(B, max(S_, s_max), rules=(
            current_rules() if isinstance(x, DTensor) else None))
        for (j, i, _, _), c in zip(self._layers(params), caches):
            self._store(cache, j, i, c)
        return logits, cache, S_

    def _store(self, cache, j, i, c):
        """Write layer (j, i)'s prefill cache entry ``c`` into ``cache`` in
        place: attention's and MLA's at the head of the sequence, an SSM's
        state whole (on DTensors each rank writes its own shard,
        ``parallel.sharding.write_block``)."""
        map_cache(lambda big, one: write_block(big, one.unsqueeze(0),
                                               (j,) + (0,) * one.ndim),
                  cache[i], c)

    def _cache_smax(self, cache) -> int:
        """The sequence capacity of the first attention or MLA position's
        cache (0 where the period has none)."""
        for kind, c in zip(self.cfg.pattern, cache):
            if kind in ATTENTION:
                return c[0].shape[2]
        return 0

    def decode_step(self, params, cache, t, batch):
        """One new token per row.  t: int, 0-d or (B,) positions (ragged
        rows; after a patch prefix, P + the text position);
        batch['tokens']: (B, 1) [(B, 1, ncb)].  Writes the cache in place
        and returns (logits (B, V) [(B, ncb, V)], cache)."""
        cfg = self.cfg
        x = annotate(self._embed(params, batch), "batch", None, "embed")
        t = torch.as_tensor(t, device=x.device).long()
        kv_positions = torch.arange(self._cache_smax(cache), device=x.device)
        for j, i, p, pf in self._layers(params):
            c = map_cache(lambda a: a[j], cache[i])
            x = self._block_decode(i, p, pf, x, c, t, kv_positions)
        x = L.rms_norm(x, params["final"]["ln"], cfg.norm_eps)
        return self._head(params, x)[:, 0], cache
