"""Batched serving engine (port of ``repro.serve.engine``).

Slot-based continuous batching over a fixed-capacity decode batch:

- requests enter a queue; free slots are filled by running ``prefill`` for
  the incoming prompt (right-padded to its bucket) and copying its cache
  into the batch cache at the slot index, in place;
- one ``decode_step`` advances every slot by a token (inactive slots run
  too, at their stale position, as in JAX: the batch shape never changes);
- finished slots (eos or max tokens) are retired and refilled.

With codebooks (musicgen) a prompt is ``(n, ncb)``, each step samples one
token a codebook over the last axis, a result's tokens are lists of
``ncb``, and there is no EOS stop, as in JAX.  No patches are passed: a
patch prefix goes through ``Model.prefill``.

Sampling stays on the host with numpy: greedy or temperature.  The engine
records the host time of each prefill (cache splice and the logits' copy
to the host included) and of each decode step in ``timings``.

Under sharding rules (``rules`` with a mesh over the process group) every
rank runs the same engine on the same requests: the parameters are placed
by ``param_shardings``, the cache by ``Model.cache_axes``, and each
prefill's and decode step's tokens by their batch spec (a batch-1 prompt
falls back to replicated); ``prefill`` and ``decode_step`` run under the
rules, the logits are made whole before the host samples them, and a
prefill's cache is spliced into its slot rank by rank
(``parallel.sharding.write_block``): nothing of the batch cache moves.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..models.model import Model, Params, map_cache
from ..parallel.sharding import (NamedSharding, ShardingRules, axis_rules,
                                 distribute, place, write_block)


def bucket_length(n: int, buckets: Sequence[int]) -> int:
    """Pad length ``n`` up to the smallest bucket that holds it (the last
    bucket when none does; ``n`` itself with no buckets)."""
    if not buckets:
        return n
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclass
class ServeConfig:
    batch_size: int = 8
    s_max: int = 512
    max_new_tokens: int = 64
    temperature: float = 0.0        # 0 = greedy
    eos_id: Optional[int] = None
    # () = prefill at the exact prompt length; nonempty = pad prompts up to
    # bucket sizes
    prompt_buckets: Sequence[int] = ()
    seed: int = 0


@dataclass
class Request:
    uid: int
    tokens: np.ndarray              # (S_prompt[, ncb]) prompt token ids
    max_new_tokens: Optional[int] = None


@dataclass
class Result:
    uid: int
    tokens: List[int] = field(default_factory=list)


def _whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


class Engine:
    """The engine on ``model.device``; ``rules`` with a mesh runs it sharded
    (every rank the same engine), None on one device."""

    def __init__(self, model: Model, params: Params, sc: ServeConfig,
                 rules: Optional[ShardingRules] = None):
        self.model = model
        self.sc = sc
        self.device = model.device
        self.rules = rules if rules is not None and rules.mesh is not None \
            else None
        B = sc.batch_size
        self.cache = model.init_cache(B, sc.s_max, rules=self.rules)
        if self.rules is not None:
            from ..train.step import param_shardings
            params = place(params, param_shardings(model, self.rules))
        self.params = params
        self.lengths = np.zeros(B, np.int64)         # per-slot position
        self.budget = np.zeros(B, np.int64)
        self.active = np.zeros(B, bool)
        self.slot_uid = np.full(B, -1, np.int64)
        self.results: Dict[int, Result] = {}
        self.queue: List[Request] = []
        self.last_token = np.zeros((B,) + self._tok_trailing(), np.int64)
        self.timings: Dict[str, List[float]] = {"prefill_s": [],
                                                "decode_s": []}
        self._rng = np.random.default_rng(sc.seed)

    def _tok_trailing(self):
        ncb = self.model.cfg.n_codebooks
        return (ncb,) if ncb else ()

    def _tokens(self, toks: np.ndarray, axes):
        """Host tokens on the device; under rules placed by ``axes``'
        spec (each rank keeps its slice)."""
        t = torch.from_numpy(toks).to(self.device)
        if self.rules is None:
            return t
        axes = axes + (None,) * (t.ndim - len(axes))
        return distribute(t, NamedSharding(self.rules.mesh, self.rules.spec(
            *axes, dims=t.shape)))

    def _token(self, tok):
        """A sampled token as a result holds it: an int, or one a codebook."""
        return list(map(int, tok)) if self.model.cfg.n_codebooks \
            else int(tok)

    # -- public API -----------------------------------------------------------

    def submit(self, req: Request):
        self.queue.append(req)
        self.results[req.uid] = Result(req.uid)

    def _bucket(self, n):
        return bucket_length(n, self.sc.prompt_buckets)

    def _admit(self):
        """Fill free slots from the queue (prefill + cache splice)."""
        for slot in np.nonzero(~self.active)[0]:
            if not self.queue:
                break
            req = self.queue.pop(0)
            n = len(req.tokens)
            toks = np.zeros((1, self._bucket(n)) + self._tok_trailing(),
                            np.int64)
            toks[0, :n] = req.tokens
            t0 = time.perf_counter()
            batch = {"tokens": self._tokens(toks, ("batch", "seq"))}
            with axis_rules(self.rules):
                logits, cache1, _ = self.model.prefill(
                    self.params, batch, self.sc.s_max,
                    logits_at=torch.tensor([n - 1], device=self.device))
            # splice the single-request cache into slot `slot`, in place
            map_cache(lambda big, one: write_block(
                big, one, (0, int(slot)) + (0,) * (one.ndim - 2)),
                self.cache, cache1)
            logits = _whole(logits).cpu().numpy()
            self.timings["prefill_s"].append(time.perf_counter() - t0)
            tok0 = self._sample(logits[0])
            self.last_token[slot] = tok0
            self.lengths[slot] = n
            # the prefill-sampled token is the first generated token
            self.budget[slot] = (req.max_new_tokens
                                 or self.sc.max_new_tokens) - 1
            self.active[slot] = True
            self.slot_uid[slot] = req.uid
            self.results[req.uid].tokens.append(self._token(tok0))

    def _sample(self, logits):
        if self.sc.temperature <= 0:
            return np.argmax(logits, axis=-1).astype(np.int32)
        z = logits / self.sc.temperature
        z = z - z.max(-1, keepdims=True)
        p = np.exp(z)
        p /= p.sum(-1, keepdims=True)
        flat = p.reshape(-1, p.shape[-1])
        out = np.array([self._rng.choice(len(q), p=q) for q in flat],
                       np.int32)
        return out.reshape(p.shape[:-1])

    def step(self) -> int:
        """Admit + one decode step for all slots; returns #active."""
        self._admit()
        if not self.active.any():
            return 0
        t0 = time.perf_counter()
        with axis_rules(self.rules):
            logits, self.cache = self.model.decode_step(
                self.params, self.cache,
                torch.from_numpy(self.lengths).to(self.device),
                {"tokens": self._tokens(self.last_token[:, None],
                                        ("batch", None))})
        logits = _whole(logits).cpu().numpy()
        self.timings["decode_s"].append(time.perf_counter() - t0)
        for slot in np.nonzero(self.active)[0]:
            nxt = self._sample(logits[slot])
            self.last_token[slot] = nxt
            self.lengths[slot] += 1
            self.budget[slot] -= 1
            uid = int(self.slot_uid[slot])
            val = self._token(nxt)
            self.results[uid].tokens.append(val)
            eos = (self.sc.eos_id is not None
                   and not self.model.cfg.n_codebooks
                   and val == self.sc.eos_id)
            if eos or self.budget[slot] <= 0 \
                    or self.lengths[slot] >= self.sc.s_max - 1:
                self.active[slot] = False
                self.slot_uid[slot] = -1
        return int(self.active.sum())

    def run(self) -> Dict[int, Result]:
        while self.queue or self.active.any():
            self.step()
        return self.results
