"""The one generator every traffic mix is read by.

A mix is a JSON file under ``bench/traffic/``.  ``"kind": "train"``: a
training batch of ``batch`` x ``seq`` tokens (``grad_accum`` microbatches),
each step's rows new, drawn uniformly over the vocabulary from the seed.
``"kind": "serve"``: requests in a closed loop (``"loop": "closed"``:
``clients``, each sending its next request when its last one completes)
or an open one (``"open"``: arrivals whose gaps follow the law
``arrival``).

Each law (a prompt's or an output's length, an arrival's gap) is a fixed
set of ``strata`` values (``STRATA`` unless the law says) at the
quantiles (i + 1/2) / strata of its distribution, which every seed shares
and deals out in its own order (a fresh shuffle each time a set is spent);
each prompt's tokens are drawn uniformly from the seed.  So two seeds ask
for the same work, arriving alike, in another order.  A gap law's set is
scaled so that its mean gap is 1 / ``rate``.  The distributions built in
are ``uniform`` and ``loguniform`` over [``min``, ``max``] and
``exponential``; any other name is a file ``bench/traffic/<name>.py`` whose
``quantiles(q, law)`` gives the values at the quantiles ``q`` (an array)
of the law's own parameters.
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch


# the values a law is cut into, unless it says
STRATA = 256


def _rng(seed: int, *key: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, *key]))


def quantiles(law: dict, q: np.ndarray, root: Optional[Path] = None):
    """The values of ``law`` at the quantiles ``q``."""
    name = law["dist"]
    if name == "loguniform":
        lo, hi = math.log(law["min"]), math.log(law["max"])
        return np.exp(lo + q * (hi - lo))
    if name == "uniform":
        return law["min"] + q * (law["max"] - law["min"] + 1) - 0.5
    if name == "exponential":
        return -np.log1p(-q) / law["rate"]
    path = (root or Path(__file__).resolve().parents[2]) / "bench" \
        / "traffic" / f"{name}.py"
    if not path.exists():
        raise ValueError(f"unknown distribution {name!r} (no {path})")
    spec = importlib.util.spec_from_file_location(
        f"bench.traffic.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return np.asarray(mod.quantiles(q, law), dtype=np.float64)


def _q(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def strata(law: dict, n: int, root: Optional[Path] = None) -> List[int]:
    """``n`` lengths at the quantiles (i + 1/2) / n of ``law``."""
    v = quantiles(law, _q(n), root)
    return [int(x) for x in np.clip(np.rint(v), law["min"], law["max"])]


def gaps(law: dict, root: Optional[Path] = None) -> List[float]:
    """A gap law's set: its ``strata`` quantiles, scaled to the mean gap
    1 / ``rate``."""
    v = quantiles(law, _q(law.get("strata", STRATA)), root)
    return list(v * (1.0 / law["rate"]) / v.mean())


class Arrivals:
    """An open loop's gaps in the order the seed deals them."""

    def __init__(self, law: dict, seed: int, root: Optional[Path] = None):
        self.set = gaps(law, root)
        self._rng = _rng(seed, 4)
        self._deck: List[float] = []

    def next(self) -> float:
        if not self._deck:
            self._deck = [self.set[i] for i in
                          self._rng.permutation(len(self.set))][::-1]
        return self._deck.pop()


class Requests:
    """A serve mix's requests in the order the seed deals them: (uid,
    prompt tokens, output length)."""

    def __init__(self, traffic: dict, seed: int, vocab: int,
                 root: Optional[Path] = None):
        self.prompts = strata(traffic["prompt"],
                              traffic["prompt"].get("strata", STRATA), root)
        self.outputs = strata(traffic["output"],
                              traffic["output"].get("strata", STRATA), root)
        self.vocab = vocab
        self.seed = seed
        self.uid = 0
        self._deck: List[Tuple[int, int]] = []
        self._rng = _rng(seed, 0)

    def next(self) -> Tuple[int, np.ndarray, int]:
        if not self._deck:
            p = self._rng.permutation(len(self.prompts))
            o = self._rng.permutation(len(self.outputs))
            self._deck = [(self.prompts[i], self.outputs[j])
                          for i, j in zip(p, o)][::-1]
        n, out = self._deck.pop()
        uid = self.uid
        self.uid += 1
        toks = _rng(self.seed, 1, uid).integers(0, self.vocab, n)
        return uid, toks.astype(np.int64), out


def train_batch(traffic: dict, vocab: int, seed: int, step: int, device):
    """Step ``step``'s batch: {"tokens", "labels"} (batch, seq) int64 on
    ``device``, the labels the tokens shifted by one."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, 2, step])
                      .generate_state(1, np.uint64)[0] >> 1))
    t = torch.randint(0, vocab, (traffic["batch"], traffic["seq"] + 1),
                      generator=g, device=device)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}
