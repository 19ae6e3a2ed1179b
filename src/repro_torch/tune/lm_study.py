"""Measured-mode LM autotuning study on the card (port of
``repro.tune.lm_study``: the paper's technique on the port's own framework,
real wall clock).

A *configuration* is a ``StepKnobs`` point (grad accumulation x remat x
attention/ssm chunking x MoE dispatch).  A configuration's step is
decomposed into recurring kernels:

    embed+loss closure        once per microbatch
    <mixer kind> fwd+bwd      n_periods x period-positions x microbatches
    <ffn kind>  fwd+bwd       likewise (the FFN kind ``none``: no kernel)
    optimizer update          once per step

The SSM mixers (``mamba_fb``, ``mlstm_fb``, ``slstm_fb``) run at
``ssm_chunk``: Mamba's and sLSTM's scans rematerialize each chunk in the
backward where the sequence is longer than one chunk
(``models/ssm.py:chunked_scan``), and mLSTM's chunkwise form takes it as
its intra-chunk length.

Each kernel is a closure keyed by a ``Signature`` carrying the knob subset
that affects it, the same signatures and occurrence counts as the JAX
study's for every point, so configurations share kernels exactly when the
paper's theory says they should (changing the MoE dispatch leaves every
attention kernel's signature intact).  A closure runs a forward+backward
(``torch.autograd.grad`` with respect to the arguments ``jax.grad`` takes)
through the port's kernels, CUDA on the card, and ends in
``torch.cuda.synchronize()`` where JAX calls ``block_until_ready``.
``SelectiveTimer`` then applies the confidence-interval skipping.

The study runs on the card unless the caller passes ``device="cpu"``;
``reduced=False`` runs the published widths (the JAX study always takes
the reduced configuration).
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core.signatures import Signature, comp_sig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm
from repro_torch.models.model import (Model, ModelKnobs, check_supported,
                                      init_params)
from .selective import SelectiveTimer


@dataclass(frozen=True)
class StepKnobs:
    name: str
    grad_accum: int = 1
    remat: str = "none"          # 'none' | 'full'
    kv_chunk: int = 32
    ssm_chunk: int = 16
    moe_dispatch: str = "sort"   # 'sort' | 'dense'


def lm_config_space(cfg: ArchConfig) -> List[StepKnobs]:
    accums = (1, 2, 4)
    remats = ("none", "full")
    kvs = (16, 64)
    moes = ("sort", "dense") if cfg.moe else ("sort",)
    ssms = (8, 32) if any(k in ("mamba", "mlstm", "slstm")
                          for k in cfg.pattern) else (16,)
    out = []
    for ga, rm, kv, md, sc in itertools.product(accums, remats, kvs, moes,
                                                ssms):
        out.append(StepKnobs(
            name=f"ga{ga}-{rm}-kv{kv}-{md}-ssm{sc}",
            grad_accum=ga, remat=rm, kv_chunk=kv, ssm_chunk=sc,
            moe_dispatch=md))
    return out


def _block_params(params, pos: int, period: int) -> Dict[str, torch.Tensor]:
    """One period's params for one position: leaf views of the stacks."""
    return {k: v[period].detach() for k, v in params[f"pos{pos}"].items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _flatten(tree, path=()):
    """[(path, tensor)] of a tensor or a nested dict of tensors."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _flatten(v, path + (k,))]
    return [(path, tree)]


def _unflatten(paths, leaves):
    out: dict = {}
    for path, t in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


def grad_closure(loss: Callable, remat: str, device: torch.device,
                 unread: Tuple[str, ...] = ()):
    """``fn(params, *inputs) -> grads`` of ``loss(params, *inputs)`` with
    respect to ``params`` (a dict of tensors, or of dicts), as ``jax.grad``
    takes the first argument; ``remat="full"`` recomputes the forward in
    the backward (``jax.checkpoint``).  ``unread`` names the parameters
    (``/``-joined paths) the loss does not read: they get zeros, as from
    ``jax.grad``; any other parameter outside the graph, or a named one in
    it, raises.  Ends in a device synchronize."""

    def fn(params, *inputs):
        paths, leaves = zip(*_flatten(params))
        leaves = [t.detach().requires_grad_(True) for t in leaves]

        def rebuilt(*ts):
            return loss(_unflatten(paths, ts), *inputs)

        with torch.enable_grad():
            if remat == "full":
                value = checkpoint(rebuilt, *leaves, use_reentrant=False)
            else:
                value = rebuilt(*leaves)
            grads = torch.autograd.grad(value, leaves, allow_unused=True)
        for path, g in zip(paths, grads):
            if (g is None) != ("/".join(path) in unread):
                raise RuntimeError(
                    f"parameter {'/'.join(path)} is {'not ' * (g is None)}"
                    f"read by the loss (unread: {unread})")
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, grads)]
        _sync(device)
        return _unflatten(paths, grads)
    return fn


def attn_loss(cfg: ArchConfig, knobs: StepKnobs, positions):
    """sum(h^2) of the attention block at these knobs, as the JAX study's."""

    def loss(mix, x):
        h, _ = L.attn_block(mix, x, cfg, positions=positions,
                            kv_chunk=knobs.kv_chunk)
        return torch.sum(h * h)
    return loss


def mla_loss(cfg: ArchConfig, knobs: StepKnobs, positions):
    """sum(h^2) of the MLA block at these knobs, as the JAX study's: its
    gradients go through the flash backward at (d_nope + d_rope, d_v)."""

    def loss(mix, x):
        h, _ = L.mla_block(mix, x, cfg, positions=positions,
                           kv_chunk=knobs.kv_chunk)
        return torch.sum(h * h)
    return loss


def _ssm_loss(kind: str):
    """The loss factory of an SSM mixer: sum(h^2) of ``ssm.{kind}_block``
    at ``ssm_chunk``, as the JAX study's (mLSTM in its chunkwise form,
    where the knob is the intra-chunk length)."""

    def make(cfg: ArchConfig, knobs: StepKnobs, positions):
        def loss(mix, x):
            h, _ = getattr(ssm, f"{kind}_block")(mix, x, cfg,
                                                 chunk=knobs.ssm_chunk)
            return torch.sum(h * h)
        return loss
    return make


mamba_loss, mlstm_loss, slstm_loss = (_ssm_loss(k) for k in
                                      ("mamba", "mlstm", "slstm"))

# every mixer kind's loss (``check_supported``'s ``MIXERS``)
MIXER_LOSSES = {"attn": attn_loss, "mla": mla_loss, "mamba": mamba_loss,
                "mlstm": mlstm_loss, "slstm": slstm_loss}


def dense_loss(cfg: ArchConfig):
    """sum(h^2) of the dense FFN block, as the JAX study's."""

    def loss(ffn, x):
        h = L.ffn_block(ffn, x, cfg)
        return torch.sum(h * h)
    return loss


# the MoE FFN's parameters its loss does not read: the reference's MoE
# block makes a norm and routes the un-normalized residual
MOE_UNREAD = ("ln",)


def moe_loss(cfg: ArchConfig, dispatch: str):
    """sum(h^2) of the MoE FFN with this dispatch, as the JAX study's
    (``MOE_UNREAD`` names the parameter it leaves out of the graph)."""

    def loss(ffn, x):
        h = M.moe_ffn(ffn, x, cfg, dispatch=dispatch)
        return torch.sum(h * h)
    return loss


def embed_loss(model: Model, data):
    """mean(logits^2) of embed -> final norm -> head, as the JAX study's:
    over every position, a patch prefix's included, and every codebook."""
    cfg = model.cfg

    def loss(params):
        x = model._embed(params, data)
        x = L.rms_norm(x, params["final"]["ln"], cfg.norm_eps)
        logits = model._head(params, x)
        return torch.mean(logits.float() ** 2)
    return loss


class LMStudy:
    """Benchmarks StepKnobs configurations for one architecture."""

    def __init__(self, arch: str, *, batch: int = 2, seq: int = 32,
                 seed: int = 0, device: DeviceLike = None,
                 reduced: bool = True):
        self.cfg = get_config(arch, reduced=reduced)
        check_supported(self.cfg)
        self.device = resolve_device(device)
        self.batch, self.seq = batch, seq
        gen = torch.Generator().manual_seed(seed)
        self.params = init_params(self.cfg, gen, self.device)
        cfg = self.cfg
        tshape = ((batch, seq, cfg.n_codebooks) if cfg.n_codebooks
                  else (batch, seq))
        self.batch_data = {
            k: torch.randint(0, cfg.vocab, tshape,
                             generator=gen).to(self.device)
            for k in ("tokens", "labels")}
        if cfg.n_patches:
            self.batch_data["patches"] = torch.randn(
                (batch, cfg.n_patches, cfg.d_model), generator=gen
            ).to(self.device)
        self._fns: Dict[Signature, callable] = {}
        self._args: Dict[Signature, tuple] = {}
        # one build per signature when two threads (a daemon's serve loop
        # and its background study) ask for the same kernel at once
        self._kernel_lock = threading.Lock()

    # -- kernel construction ---------------------------------------------------

    def _kernel(self, sig: Signature, build):
        """Get-or-build the closure + concrete args for a signature; the
        first call (which builds the CUDA kernels on first use, and warms
        up) happens outside the timed region."""
        with self._kernel_lock:
            if sig not in self._fns:
                fn, args = build()
                fn(*args)
                self._fns[sig] = fn
                self._args[sig] = args
            return self._fns[sig], self._args[sig]

    def _randn(self, seed: int, shape) -> torch.Tensor:
        gen = torch.Generator().manual_seed(seed)
        return torch.randn(shape, generator=gen).to(self.device)

    def _mixer_kernel(self, kind: str, pos: int, knobs: StepKnobs, mb: int):
        cfg = self.cfg
        S = self.seq
        sig = comp_sig(f"{kind}_fb", mb, S, cfg.d_model, knobs.kv_chunk
                       if kind in ("attn", "mla") else knobs.ssm_chunk,
                       knobs.remat)

        def build():
            p = _block_params(self.params, pos, 0)
            mix = {k[len("mix_"):]: v for k, v in p.items()
                   if k.startswith("mix_")}
            x = self._randn(pos, (mb, S, cfg.d_model))
            positions = torch.arange(S, device=self.device)
            fn = grad_closure(MIXER_LOSSES[kind](cfg, knobs, positions),
                              knobs.remat, self.device)
            return fn, (mix, x)
        return sig, build

    def _ffn_kernel(self, fk: str, pos: int, knobs: StepKnobs, mb: int):
        cfg = self.cfg
        S = self.seq
        extra = knobs.moe_dispatch if fk == "moe" else "-"
        sig = comp_sig(f"{fk}_fb", mb, S, cfg.d_model, extra, knobs.remat)

        def build():
            p = _block_params(self.params, pos, 0)
            ffn = {k[len("ffn_"):]: v for k, v in p.items()
                   if k.startswith("ffn_")}
            x = self._randn(100 + pos, (mb, S, cfg.d_model))
            if fk == "moe":
                fn = grad_closure(moe_loss(cfg, knobs.moe_dispatch),
                                  knobs.remat, self.device,
                                  unread=MOE_UNREAD)
            else:
                fn = grad_closure(dense_loss(cfg), knobs.remat, self.device)
            return fn, (ffn, x)
        return sig, build

    def _embed_loss_kernel(self, knobs: StepKnobs, mb: int):
        cfg = self.cfg
        sig = comp_sig("embed_loss_fb", mb, self.seq, cfg.vocab)

        def build():
            model = Model(cfg, ModelKnobs(kv_chunk=knobs.kv_chunk,
                                          ssm_chunk=knobs.ssm_chunk),
                          device=self.device)
            data = {k: v[:mb] for k, v in self.batch_data.items()}
            fn = grad_closure(embed_loss(model, data), "none", self.device)
            sub = {"embed": self.params["embed"],
                   "final": self.params["final"]}
            if "head" in self.params:
                sub["head"] = self.params["head"]
            return fn, (sub,)
        return sig, build

    def _opt_kernel(self):
        from repro_torch.train.optim import (AdamWConfig, adamw_init,
                                             adamw_update, tree_map)
        sig = comp_sig("adamw", sum(
            v.numel() for sub in self.params.values() for v in sub.values()))

        def build():
            oc = AdamWConfig()
            st = adamw_init(self.params)
            g = tree_map(torch.ones_like, self.params)

            def fn(p, gg, s):
                out = adamw_update(oc, p, gg, s)
                _sync(self.device)
                return out
            return fn, (self.params, g, st)
        return sig, build

    # -- one configuration benchmark --------------------------------------------

    def kernel_sequence(self, knobs: StepKnobs):
        """The step's kernel occurrence list: (sig, build, freq)."""
        cfg = self.cfg
        mb = max(self.batch // knobs.grad_accum, 1)
        counts: Dict[Signature, int] = {}
        per_step = []
        for pos, (kind, fk) in enumerate(zip(cfg.pattern, cfg.ffn_pattern)):
            per_step.append(self._mixer_kernel(kind, pos, knobs, mb))
            if fk != "none":
                per_step.append(self._ffn_kernel(fk, pos, knobs, mb))
        items = []
        for _ in range(knobs.grad_accum):
            for _ in range(cfg.n_periods):
                items.extend(per_step)
            items.append(self._embed_loss_kernel(knobs, mb))
        items.append(self._opt_kernel())
        for sig, _ in items:
            counts[sig] = counts.get(sig, 0) + 1
        return [(sig, build, counts[sig]) for sig, build in items]

    # -- session-API adapters ----------------------------------------------------

    def kernels_of(self, point):
        """``WallClockBackend`` provider: resolve a ``ConfigPoint`` (or a
        bare ``StepKnobs``) to the step's bound kernel occurrence list
        ``[(Signature, thunk, freq)]``; building and warm-up happen here,
        outside any timed region."""
        knobs = getattr(point, "payload", point) or point
        out = []
        for sig, build, freq in self.kernel_sequence(knobs):
            fn, args = self._kernel(sig, build)
            out.append((sig,
                        (lambda fn=fn, args=args: fn(*args)), freq))
        return out

    @staticmethod
    def stats_bank(*results):
        """Merge the kernel-statistics banks of completed LM study results
        (``AutotuneSession(..., collect_stats=True)``) into one transfer
        prior (``AutotuneSession(..., prior=bank)``)."""
        from repro_torch.api.transfer import StatisticsBank
        bank = StatisticsBank()
        for r in results:
            b = r.stats_bank() if hasattr(r, "stats_bank") else r
            if b:
                bank = bank.merge(b)
        return bank

    def session(self, *, policy: str = "conditional",
                tolerance: float = 0.25, search: str = "exhaustive",
                max_configs: Optional[int] = None, trials: int = 3,
                prior=None, clock=None, **kw):
        """An ``AutotuneSession`` measuring StepKnobs points with
        ``WallClockBackend`` bound to ``kernels_of`` (serial: wall-clock
        backends are not ``parallel_safe``); ``search="racing"`` races
        configurations by real wall clock (see ``race``).  ``clock``
        overrides the backend's time source (deterministic tests)."""
        from repro_torch.api import AutotuneSession, WallClockBackend
        return AutotuneSession(self.search_space(max_configs),
                               backend=WallClockBackend(self.kernels_of,
                                                        clock=clock),
                               policy=policy, tolerance=tolerance,
                               search=search, trials=trials, prior=prior,
                               **kw)

    def race(self, *, policy: str = "conditional", tolerance: float = 0.25,
             max_configs: Optional[int] = None, max_rounds: int = 6,
             prior=None, **kw):
        """Wall-clock racing study: successive elimination over the
        StepKnobs space driven by the per-kernel CIs on real measured step
        times.  Returns the ``StudyResult`` (winner in
        ``extra["best"]``)."""
        return self.session(policy=policy, tolerance=tolerance,
                            search="racing", max_configs=max_configs,
                            search_options={"max_rounds": max_rounds},
                            prior=prior, **kw).run()

    def search_space(self, max_configs: Optional[int] = None):
        """The session-API view of this study's StepKnobs space."""
        from repro_torch.api.space import RESET_POLICY, ConfigPoint, \
            SearchSpace
        pts = [ConfigPoint(name=kn.name, params={
                   "grad_accum": kn.grad_accum, "remat": kn.remat,
                   "kv_chunk": kn.kv_chunk, "ssm_chunk": kn.ssm_chunk,
                   "moe_dispatch": kn.moe_dispatch}, payload=kn)
               for kn in lm_config_space(self.cfg)]
        if max_configs is not None:
            pts = pts[:max_configs]
        return SearchSpace(name=f"lm-{self.cfg.name}", points=pts,
                           reset_between_configs=RESET_POLICY)

    def run_config(self, knobs: StepKnobs, timer: SelectiveTimer,
                   *, iters: int = 3):
        """Selective benchmark of one configuration; returns
        (predicted step time, full-execution reference time, cost)."""
        seqn = self.kernel_sequence(knobs)
        # full execution directly prior (reference; not fed to models)
        full = 0.0
        for sig, build, freq in seqn:
            fn, args = self._kernel(sig, build)
            t0 = timer.clock()
            fn(*args)
            full += timer.clock() - t0
        cost = 0.0
        pred = None
        for _ in range(iters):
            timer.begin_iteration()
            for sig, build, freq in seqn:
                fn, args = self._kernel(sig, build)
                timer.time_kernel(sig, lambda: fn(*args), freq)
            rep = timer.report()
            cost += rep.measured_time
            pred = rep.predicted_time
        return pred, full, cost
