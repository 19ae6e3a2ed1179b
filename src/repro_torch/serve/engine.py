"""Batched serving engine (port of ``repro.serve.engine``).

Slot-based continuous batching over a fixed-capacity decode batch:

- requests enter a queue; free slots are filled by running ``prefill`` for
  the incoming prompt (right-padded to its bucket) and copying its cache
  into the batch cache at the slot index, in place;
- one ``decode_step`` advances every slot by a token (inactive slots run
  too, at their stale position, as in JAX: the batch shape never changes);
- finished slots (eos or max tokens) are retired and refilled.

Sampling stays on the host with numpy: greedy or temperature.  The engine
records the host time of each prefill (cache splice and the logits' copy
to the host included) and of each decode step in ``timings``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.model import Model, Params


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
    tokens: np.ndarray              # (S_prompt,) prompt token ids
    max_new_tokens: Optional[int] = None


@dataclass
class Result:
    uid: int
    tokens: List[int] = field(default_factory=list)


class Engine:
    """Single-device engine on ``model.device``."""

    def __init__(self, model: Model, params: Params, sc: ServeConfig):
        self.model = model
        self.params = params
        self.sc = sc
        self.device = model.device
        B = sc.batch_size
        self.cache = model.init_cache(B, sc.s_max)
        self.lengths = np.zeros(B, np.int64)         # per-slot position
        self.budget = np.zeros(B, np.int64)
        self.active = np.zeros(B, bool)
        self.slot_uid = np.full(B, -1, np.int64)
        self.results: Dict[int, Result] = {}
        self.queue: List[Request] = []
        self.last_token = np.zeros(B, np.int64)
        self.timings: Dict[str, List[float]] = {"prefill_s": [],
                                                "decode_s": []}
        self._rng = np.random.default_rng(sc.seed)

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
            toks = np.zeros((1, self._bucket(n)), np.int64)
            toks[0, :n] = req.tokens
            t0 = time.perf_counter()
            batch = {"tokens": torch.from_numpy(toks).to(self.device)}
            logits, cache1, _ = self.model.prefill(
                self.params, batch, self.sc.s_max,
                logits_at=torch.tensor([n - 1], device=self.device))
            # splice the single-request cache into slot `slot`, in place
            for big_kv, one_kv in zip(self.cache, cache1):
                for big, one in zip(big_kv, one_kv):
                    big[:, slot:slot + 1].copy_(one)
            logits = logits.cpu().numpy()
            self.timings["prefill_s"].append(time.perf_counter() - t0)
            tok0 = int(self._sample(logits[0]))
            self.last_token[slot] = tok0
            self.lengths[slot] = n
            # the prefill-sampled token is the first generated token
            self.budget[slot] = (req.max_new_tokens
                                 or self.sc.max_new_tokens) - 1
            self.active[slot] = True
            self.slot_uid[slot] = req.uid
            self.results[req.uid].tokens.append(tok0)

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
        logits, self.cache = self.model.decode_step(
            self.params, self.cache,
            torch.from_numpy(self.lengths).to(self.device),
            {"tokens": torch.from_numpy(self.last_token[:, None]).to(
                self.device)})
        logits = logits.cpu().numpy()
        self.timings["decode_s"].append(time.perf_counter() - t0)
        for slot in np.nonzero(self.active)[0]:
            val = int(self._sample(logits[slot]))
            self.last_token[slot] = val
            self.lengths[slot] += 1
            self.budget[slot] -= 1
            uid = int(self.slot_uid[slot])
            self.results[uid].tokens.append(val)
            eos = self.sc.eos_id is not None and val == self.sc.eos_id
            if eos or self.budget[slot] <= 0 \
                    or self.lengths[slot] >= self.sc.s_max - 1:
                self.active[slot] = False
                self.slot_uid[slot] = -1
        return int(self.active.sum())

    def run(self) -> Dict[int, Result]:
        while self.queue or self.active.any():
            self.step()
        return self.results
