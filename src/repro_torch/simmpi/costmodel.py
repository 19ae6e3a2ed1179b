"""Stochastic kernel cost models.

The paper measures real wall-clock on Stampede2 (KNL + Omni-Path) and
observes high run-to-run variability.  On this CPU-only container we provide
two timing sources:

- **modeled** (this module): a calibrated stochastic cost model — a
  deterministic roofline/alpha-beta part plus multiplicative lognormal noise
  and a persistent per-(signature, allocation) bias.  The bias term models
  the paper's observation that distinct node allocations give systematically
  different timings (they run every experiment on two allocations); the
  lognormal term models run-to-run noise (network/memory contention).
- **measured** (linalg.blas): real wall-clock of local jnp BLAS kernels at
  laptop scale, used by the measured-mode demo and tests.

Both plug into the Runtime through the same ``sample(sig, rng)`` interface.
"""

from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from repro_torch.core.signatures import Signature, flops_of, bytes_of
from repro_torch.core.stats import norm_ppf


# -- counter-based (Philox-style) draw discipline -----------------------------
#
# splitmix64 finalizer constants: the i-th draw of a model keyed by ``key``
# is ``mix64(key + (i + 1) * GAMMA)``, so any contiguous run of draw slots
# can be generated as one vectorized pass over ``arange`` — there is no
# sequential generator state to thread through, only the cursor
# ``draw_index``.  That is what lets a straggler-enabled cost model batch
# its mixed normal/uniform draws per segment: each event owns THREE fixed
# counter slots (normal, straggler gate, straggler scale), consumed
# positionally whether or not the straggler branch fires.
_MIX_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_MIX_M1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX_M2 = np.uint64(0x94D049BB133111EB)
_U64_TO_UNIT = 2.0 ** -53      # (z >> 11) + 0.5 in (0, 1), never 0 or 1


def counter_uniforms(key: np.uint64, start: int, n: int) -> np.ndarray:
    """Uniform(0,1) deviates for counter slots [start, start + n)."""
    with np.errstate(over="ignore"):
        z = (np.arange(start + 1, start + n + 1, dtype=np.uint64)
             * _MIX_GAMMA + key)
        z ^= z >> np.uint64(30)
        z *= _MIX_M1
        z ^= z >> np.uint64(27)
        z *= _MIX_M2
        z ^= z >> np.uint64(31)
    return ((z >> np.uint64(11)).astype(np.float64) + 0.5) * _U64_TO_UNIT


@dataclass(frozen=True)
class MachineSpec:
    """Per-node compute + interconnect constants."""

    name: str
    # compute
    peak_flops: float          # attainable flop/s per rank (not marketing peak)
    mem_bw: float              # bytes/s per rank
    comp_latency: float        # fixed per-kernel invocation overhead (s)
    # network (alpha-beta, per message)
    net_alpha: float           # latency per message (s)
    net_beta: float            # seconds per byte (1/injection bandwidth)


# Stampede2: KNL ~3 Tflop/s marketing per node / 64 ranks used per node and
# realistic BLAS efficiency => ~20 Gflop/s per rank; OPA 12.5 GB/s injection
# shared per node => ~0.8 GB/s per rank sustained.
KNL_STAMPEDE2 = MachineSpec(
    name="knl-stampede2",
    peak_flops=20e9,
    mem_bw=6e9,
    comp_latency=2e-6,
    net_alpha=5e-6,
    net_beta=1.0 / 0.8e9,
)

# TPU v5e chip: 197 Tflop/s bf16, 819 GB/s HBM, ~50 GB/s/link ICI.
TPU_V5E = MachineSpec(
    name="tpu-v5e",
    peak_flops=197e12,
    mem_bw=819e9,
    comp_latency=2e-6,
    net_alpha=1e-6,
    net_beta=1.0 / 50e9,
)


class CostModel:
    """time(sig) = deterministic(sig) * bias(sig, allocation) * lognormal(sigma)

    - deterministic compute: max(flops/peak, bytes/mem_bw) + latency
    - deterministic collective: tree/ring alpha-beta terms by op kind
    - ``allocation`` reseeds the persistent bias field — the paper's "two
      distinct node allocations".
    - a small straggler probability injects heavy-tail spikes (network/OS
      noise), which is what makes tight confidence intervals *earned* rather
      than automatic.
    """

    def __init__(self, spec: MachineSpec, *, allocation: int = 0,
                 noise: float = 0.08, comm_noise: float = 0.18,
                 bias_sigma: float = 0.06, straggler_p: float = 0.002,
                 straggler_scale: float = 4.0, seed: int = 0,
                 counter_rng: bool = False):
        self.spec = spec
        self.noise = noise
        self.comm_noise = comm_noise
        self.bias_sigma = bias_sigma
        self.straggler_p = straggler_p
        self.straggler_scale = straggler_scale
        self._bias_seed = (seed * 1_000_003 + allocation * 7919) & 0xFFFFFFFF
        self._bias: Dict[Signature, float] = {}
        # deterministic-part cache: base_time(sig) * bias(sig) per signature
        # (both factors are pure in sig), so the per-sample cost is one dict
        # lookup plus the stochastic draw
        self._det: Dict[Signature, float] = {}
        # counter-based draw discipline (opt-in: the legacy sequential
        # Generator stream keeps every committed golden/report valid).
        # ``draw_index`` is the public RNG-stream cursor — the counter-mode
        # analogue of Generator.bit_generator.state, pinned by the
        # bit-identity gates.
        self.counter_rng = bool(counter_rng)
        self.draw_index = 0
        with np.errstate(over="ignore"):
            self._ctr_key = (np.uint64(seed & 0xFFFFFFFFFFFFFFFF)
                             * np.uint64(0x2545F4914F6CDD1D)
                             + np.uint64((allocation * 7919 + 1)
                                         & 0xFFFFFFFFFFFFFFFF))

    # -- deterministic part --------------------------------------------------

    def base_time(self, sig: Signature) -> float:
        if sig.kind == "comp":
            f = sig.flops if hasattr(sig, "flops") else None
            fl = flops_of(sig)
            by = bytes_of(sig)
            return (max(fl / self.spec.peak_flops, by / self.spec.mem_bw)
                    + self.spec.comp_latency)
        # communication: params = (nbytes, comm_size, comm_stride)
        nbytes, p = float(sig.params[0]), max(int(sig.params[1]), 2)
        a, b = self.spec.net_alpha, self.spec.net_beta
        lg = math.log2(p)
        op = sig.name
        if op in ("send", "recv", "isend", "sendrecv"):
            return a + nbytes * b
        if op == "bcast":
            return lg * a + 2.0 * nbytes * b          # scatter+allgather
        if op in ("reduce", "scatter", "gather"):
            return lg * a + nbytes * b
        if op == "allreduce":
            return 2 * lg * a + 2.0 * nbytes * b      # RS + AG ring
        if op == "allgather":
            return lg * a + nbytes * b * (p - 1) / p * 2
        if op == "alltoall":
            return (p - 1) * a + nbytes * b
        if op == "barrier":
            return 2 * lg * a
        return a + nbytes * b

    # -- stochastic part ------------------------------------------------------

    def _bias_of(self, sig: Signature) -> float:
        v = self._bias.get(sig)
        if v is None:
            # crc32 of the stable string form, NOT hash(): the builtin str
            # hash is PYTHONHASHSEED-randomized per interpreter, which
            # would make the bias field differ across processes and break
            # checkpoint-resumed studies (repro.api session journals) and
            # any cross-process reproduction of a sweep
            h = (zlib.crc32(str(sig).encode())
                 ^ self._bias_seed) & 0xFFFFFFFF
            rng = np.random.default_rng(h)
            v = float(np.exp(rng.normal(0.0, self.bias_sigma)))
            self._bias[sig] = v
        return v

    def batch_info(self, sigs):
        """Vectorized-draw support for the engine's batched cold path.

        Returns ``(det, sigma)`` — draw-order arrays of the per-signature
        deterministic parts and lognormal sigmas — when a batch of
        ``sigs`` can be sampled as ``det * exp(sigma * standard_normal(n))``
        with the exact RNG stream of per-event ``sample`` calls:
        ``Generator.normal(0, s)`` is bitwise ``standard_normal() * s``
        and vectorized fills consume the bit stream identically to
        repeated scalar draws, so this holds whenever every per-event draw
        is the single normal — i.e. the straggler branch is off.  With
        stragglers on (each event draws normal + uniform(s), a
        data-dependent interleaving no vector call reproduces) returns
        ``None`` and the engine falls back to per-event scalar ``sample``
        calls, which preserve the stream by construction.  Counter-mode
        models return ``None`` here too: their stream lives on the
        ``draw_index`` cursor, and the engine batches them through
        ``sample_block`` instead (which handles stragglers)."""
        if self.counter_rng or self.straggler_p > 0 or not sigs:
            return None
        det_cache = self._det
        n = len(sigs)
        det = np.empty(n)
        sigma = np.empty(n)
        comm_noise, noise = self.comm_noise, self.noise
        for i, sig in enumerate(sigs):
            d = det_cache.get(sig)
            if d is None:
                d = self.base_time(sig) * self._bias_of(sig)
                det_cache[sig] = d
            det[i] = d
            sigma[i] = comm_noise if sig.kind == "comm" else noise
        return det, sigma

    def sample(self, sig: Signature, rng: np.random.Generator) -> float:
        det = self._det.get(sig)
        if det is None:
            det = self.base_time(sig) * self._bias_of(sig)
            self._det[sig] = det
        sigma = self.comm_noise if sig.kind == "comm" else self.noise
        if self.counter_rng:
            # counter discipline: 3 fixed slots per event; the scalar path
            # computes through the SAME vectorized ufuncs (on length-1
            # arrays) as sample_block, so a segment drawn in one pass is
            # bitwise identical to per-event draws
            i = self.draw_index
            self.draw_index = i + 3
            u = counter_uniforms(self._ctr_key, i, 3)
            t = det * float(np.exp(sigma * norm_ppf(u[0:1])[0]))
            if self.straggler_p > 0 and u[1] < self.straggler_p:
                t *= 1.0 + float(u[2]) * self.straggler_scale
            return t
        t = det * float(np.exp(rng.normal(0.0, sigma)))
        if self.straggler_p > 0 and rng.random() < self.straggler_p:
            t *= 1.0 + rng.random() * self.straggler_scale
        return t

    def sample_block(self, sigs) -> Optional[np.ndarray]:
        """Draw one time per signature in a single vectorized pass.

        Only available in counter mode (returns ``None`` otherwise, and the
        engine falls back to ``batch_info`` / per-event ``sample``).  Unlike
        ``batch_info`` this handles straggler-enabled models too: every
        event owns 3 positional counter slots regardless of whether its
        straggler branch fires, so the block draw consumes exactly the
        counters the equivalent per-event ``sample`` calls would — same
        cursor advance, bitwise-identical times."""
        if not self.counter_rng or not sigs:
            return None
        det_cache = self._det
        n = len(sigs)
        det = np.empty(n)
        sigma = np.empty(n)
        comm_noise, noise = self.comm_noise, self.noise
        for i, sig in enumerate(sigs):
            d = det_cache.get(sig)
            if d is None:
                d = self.base_time(sig) * self._bias_of(sig)
                det_cache[sig] = d
            det[i] = d
            sigma[i] = comm_noise if sig.kind == "comm" else noise
        i = self.draw_index
        self.draw_index = i + 3 * n
        u = counter_uniforms(self._ctr_key, i, 3 * n).reshape(n, 3)
        t = det * np.exp(sigma * norm_ppf(u[:, 0]))
        p = self.straggler_p
        if p > 0:
            mask = u[:, 1] < p
            if mask.any():
                t[mask] *= 1.0 + u[mask, 2] * self.straggler_scale
        return t
