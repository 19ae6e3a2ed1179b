"""Model assembly for the attention families: parameters, forward, prefill,
decode (port of ``repro.models.model`` for ``pattern=("attn",)`` with
``ffn_pattern`` ``("dense",)`` or ``("moe",)``, and ``pattern=("mla",)``
with ``("moe",)``, deepseek-v2).

Parameters are a plain dict of tensors, as in JAX, with every block weight
stacked over layers (leading ``n_layers`` dim; projections 2-D, see
``layers.py``).  The ``lax.scan`` over periods is a loop over layers.  The
cache keeps the JAX structure ``((k, v),)``, updated in place: ``k``/``v``
of shape ``(n_layers, B, s_max, KVH, dh)`` under attention, and MLA's
latent ``c_kv (n_layers, B, s_max, kv_lora)`` and ``k_rope (n_layers, B,
s_max, d_rope)``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterator, Tuple

import torch

from ..configs.base import ArchConfig
from ..device import DeviceLike, resolve_device
from . import layers as L
from . import moe as M

Params = Dict[str, Dict[str, torch.Tensor]]


@dataclass(frozen=True)
class ModelKnobs:
    """Step-function choices of the attention families (the JAX
    ``ModelKnobs`` fields that the port's paths read, with JAX's defaults;
    ``remat`` is read by the tuning loop, ``tune/lm_study.py``)."""

    kv_chunk: int = 1024          # flash-attention KV chunk
    moe_dispatch: str = "a2a"     # 'a2a' (one device: 'sort'), 'sort', 'dense'
    remat: str = "full"           # 'none' | 'full'
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    logits_f32: bool = True


# the (pattern, ffn_pattern) pairs the port runs
SUPPORTED = ((("attn",), ("dense",)), (("attn",), ("moe",)),
             (("mla",), ("moe",)))


def check_supported(cfg: ArchConfig) -> None:
    if ((cfg.pattern, cfg.ffn_pattern) not in SUPPORTED
            or cfg.n_codebooks or cfg.n_patches):
        raise NotImplementedError(
            f"{cfg.name}: the port serves the attention families only "
            f"((pattern, ffn_pattern) in {SUPPORTED}, no frontend stubs); "
            f"got {cfg.pattern}/{cfg.ffn_pattern}")


def _mix_spec(cfg: ArchConfig) -> Dict[str, Tuple[tuple, float]]:
    """The mixer's (shape, fan_in) per parameter, stacked over layers (JAX
    ``_kind_params`` with the fan-ins there).  The JAX init zeroes every
    name ending in ``_b`` (meant for biases), which takes in MLA's
    ``wq_b``, ``wk_b`` and ``wv_b`` and makes its block's output zero; the
    port draws them from their fan-ins, so the path computes something."""
    D, P, H = cfg.d_model, cfg.n_layers, cfg.n_heads
    if cfg.pattern == ("mla",):
        m = cfg.mla
        return {"mix_ln": ((P, D), 0.0),
                "mix_wq_a": ((P, D, m.q_lora), D),
                "mix_q_ln": ((P, m.q_lora), 0.0),
                "mix_wq_b": ((P, m.q_lora, H * (m.d_nope + m.d_rope)),
                             m.q_lora),
                "mix_wkv_a": ((P, D, m.kv_lora + m.d_rope), D),
                "mix_kv_ln": ((P, m.kv_lora), 0.0),
                "mix_wk_b": ((P, m.kv_lora, H * m.d_nope), m.kv_lora),
                "mix_wv_b": ((P, m.kv_lora, H * m.d_v), m.kv_lora),
                "mix_wo": ((P, H * m.d_v, D), H * m.d_v)}
    HD, KD = H * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    return {"mix_ln": ((P, D), 0.0),
            "mix_wq": ((P, D, HD), D), "mix_wk": ((P, D, KD), D),
            "mix_wv": ((P, D, KD), D), "mix_wo": ((P, HD, D), HD)}


def _ffn_spec(cfg: ArchConfig) -> Dict[str, Tuple[tuple, float]]:
    """The FFN's (shape, fan_in) per parameter, stacked over layers (JAX
    ``_ffn_params``)."""
    D, P = cfg.d_model, cfg.n_layers
    out = {"ffn_ln": ((P, D), 0.0)}
    if cfg.ffn_pattern == ("dense",):
        F = cfg.d_ff
        out.update({"ffn_w_gate": ((P, D, F), D), "ffn_w_up": ((P, D, F), D),
                    "ffn_w_down": ((P, F, D), F)})
        return out
    e = cfg.moe
    E, Fe = e.n_experts, e.d_ff_expert
    out.update({"ffn_router": ((P, D, E), D),
                "ffn_w_gate": ((P, E, D, Fe), D),
                "ffn_w_up": ((P, E, D, Fe), D),
                "ffn_w_down": ((P, E, Fe, D), Fe)})
    if e.n_shared:
        Fs = e.n_shared * Fe
        out.update({"ffn_sh_gate": ((P, D, Fs), D),
                    "ffn_sh_up": ((P, D, Fs), D),
                    "ffn_sh_down": ((P, Fs, D), Fs)})
    return out


def spec_tree(cfg: ArchConfig) -> Dict[str, Dict[str, Tuple[tuple, float]]]:
    """(shape, fan_in) per parameter; fan 0 = zeros, -1 = embedding init."""
    check_supported(cfg)
    D, V = cfg.d_model, cfg.vocab
    tree = {
        "embed": {"tok": ((V, D), -1)},
        "pos0": {**_mix_spec(cfg), **_ffn_spec(cfg)},
        "final": {"ln": ((D,), 0.0)},
    }
    if not cfg.tie_embeddings:
        tree["head"] = {"w": ((D, V), D)}
    return tree


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device: DeviceLike = None,
                dtype: torch.dtype = torch.float32) -> Params:
    """Random weights with the JAX init's distributions: norms zero (scale
    1 + w = 1), embeddings N(0, 0.02^2), projections N(0, 1/fan_in).
    Drawn on the CPU from ``generator``, so one seed gives the same weights
    on every device."""
    dev = resolve_device(device)
    params: Params = {}
    for g, sub in sorted(spec_tree(cfg).items()):
        for nm, (shape, fan) in sorted(sub.items()):
            if fan == 0.0:
                w = torch.zeros(shape)
            else:
                std = 0.02 if fan == -1 else 1.0 / math.sqrt(max(fan, 1))
                w = torch.randn(shape, generator=generator) * std
            params.setdefault(g, {})[nm] = w.to(device=dev, dtype=dtype)
    return params


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

    # -- embedding / head -----------------------------------------------------

    def _embed(self, params, batch):
        table = params["embed"]["tok"].to(self.knobs.compute_dtype)
        return table[batch["tokens"].long()]

    def _head(self, params, x):
        if self.knobs.logits_f32:
            x = x.float()
        if "head" in params:
            w = params["head"]["w"].to(x.dtype)
        else:   # tied: a transposed view, read in place by the kernel
            w = params["embed"]["tok"].to(x.dtype).T
        return L.linear(x, w)

    # -- layers ---------------------------------------------------------------

    def _ffn(self, pf, x):
        if self.cfg.ffn_pattern == ("moe",):
            return M.moe_ffn(pf, x, self.cfg,
                             dispatch=self.knobs.moe_dispatch)
        return L.ffn_block(pf, x, self.cfg)

    @property
    def _mla(self) -> bool:
        return self.cfg.pattern == ("mla",)

    def _layers(self, params) -> Iterator[Tuple[dict, dict]]:
        """Per layer: (mixer params, ffn params), views of the stacks."""
        stack = params["pos0"]
        for i in range(self.cfg.n_layers):
            yield ({k[4:]: v[i] for k, v in stack.items()
                    if k.startswith("mix_")},
                   {k[4:]: v[i] for k, v in stack.items()
                    if k.startswith("ffn_")})

    def _backbone(self, params, batch, *, with_cache=False):
        cfg = self.cfg
        x = self._embed(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)
        caches = []
        block = L.mla_block if self._mla else L.attn_block
        for p, pf in self._layers(params):
            h, c = block(p, x, cfg, positions=positions,
                         kv_chunk=self.knobs.kv_chunk)
            x = x + h
            x = x + self._ffn(pf, x)
            if with_cache:
                caches.append(c)
        x = L.rms_norm(x, params["final"]["ln"], cfg.norm_eps)
        return x, caches

    def forward(self, params, batch, *, with_cache=False):
        x, caches = self._backbone(params, batch, with_cache=with_cache)
        logits = self._head(params, x)
        return (logits, caches) if with_cache else logits

    # -- prefill / decode -----------------------------------------------------

    def init_cache(self, batch_size: int, s_max: int):
        cfg = self.cfg
        lead = (cfg.n_layers, batch_size, s_max)
        if self._mla:
            shapes = (lead + (cfg.mla.kv_lora,), lead + (cfg.mla.d_rope,))
        else:
            shapes = (lead + (cfg.n_kv_heads, cfg.head_dim),) * 2
        kw = dict(dtype=self.knobs.compute_dtype, device=self.device)
        return (tuple(torch.zeros(s, **kw) for s in shapes),)

    def prefill(self, params, batch, s_max: int, logits_at=None):
        """Run the full prompt, build an s_max-capacity cache.

        ``logits_at``: optional (B,) positions of each row's true prompt end
        (right-padded batches); default = last position.  Returns
        (logits (B, V) at those positions, cache, t=prompt_len).  The pad
        positions' K/V (MLA: latents) stay in the cache; decode masks
        them."""
        x, caches = self._backbone(params, batch, with_cache=True)
        B, S = x.shape[0], x.shape[1]
        if logits_at is None:
            x_last = x[:, -1:]
        else:
            rows = torch.arange(B, device=x.device)
            x_last = x[rows, logits_at.long()][:, None]
        logits = self._head(params, x_last)[:, 0]
        k_all, v_all = self.init_cache(B, max(S, s_max))[0]
        for i, (k, v) in enumerate(caches):
            k_all[i, :, :S] = k
            v_all[i, :, :S] = v
        return logits, ((k_all, v_all),), S

    def decode_step(self, params, cache, t, batch):
        """One new token per row.  t: int, 0-d or (B,) positions (ragged
        rows); batch['tokens']: (B, 1).  Writes the cache in place and
        returns (logits (B, V), cache)."""
        cfg = self.cfg
        x = self._embed(params, batch)
        k_all, v_all = cache[0]
        t = torch.as_tensor(t, device=x.device).long()
        kv_positions = torch.arange(k_all.shape[2], device=x.device)
        decode = L.mla_decode if self._mla else L.attn_decode
        for i, (p, pf) in enumerate(self._layers(params)):
            h, _ = decode(p, x, (k_all[i], v_all[i]), cfg, t=t,
                          kv_positions=kv_positions)
            x = x + h
            x = x + self._ffn(pf, x)
        x = L.rms_norm(x, params["final"]["ln"], cfg.norm_eps)
        return self._head(params, x)[:, 0], cache
