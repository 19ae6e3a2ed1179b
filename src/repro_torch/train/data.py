"""Data pipeline: deterministic synthetic corpus + memmap-backed corpus
(port of ``repro.train.data``, numpy code as there).

Both sources yield host numpy batches; the one-device trainer moves each
batch to its device itself, and ``make_global_batch`` places a host batch
on the mesh with the batch sharding: every rank draws the same seeded
batch and keeps its slice (no collective).

The synthetic stream is Zipf-distributed tokens with a per-step PRNG keyed
on (seed, step) so restarts resume bit-identically (checkpoint/restart test
relies on this).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig, Shape
from ..parallel.sharding import distribute


@dataclass
class DataConfig:
    seed: int = 0
    zipf_a: float = 1.2
    corpus_path: Optional[str] = None   # memmap .bin of uint16/uint32 tokens


def _tokens(rng: np.random.Generator, shape, vocab: int, a: float):
    z = rng.zipf(a, size=shape).astype(np.int64)
    return ((z - 1) % vocab).astype(np.int32)


def synthetic_batch(cfg: ArchConfig, shape: Shape, step: int,
                    dc: DataConfig = DataConfig()) -> Dict[str, np.ndarray]:
    """One deterministic host batch for (arch, shape, step)."""
    rng = np.random.default_rng((dc.seed, step))
    B, S = shape.global_batch, shape.seq_len
    if cfg.n_patches:
        S_text = S - cfg.n_patches
        toks = _tokens(rng, (B, S_text + 1), cfg.vocab, dc.zipf_a)
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
            "patches": rng.standard_normal(
                (B, cfg.n_patches, cfg.d_model)).astype(np.float32),
        }
    if cfg.n_codebooks:
        toks = _tokens(rng, (B, S + 1, cfg.n_codebooks), cfg.vocab, dc.zipf_a)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    toks = _tokens(rng, (B, S + 1), cfg.vocab, dc.zipf_a)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class MemmapCorpus:
    """Flat token file (np.uint16/uint32) sampled in fixed windows."""

    def __init__(self, path: str, vocab: int, dtype=np.uint16):
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.vocab = vocab

    def batch(self, B: int, S: int, step: int, seed: int = 0):
        rng = np.random.default_rng((seed, step))
        starts = rng.integers(0, len(self.data) - S - 1, size=B)
        toks = np.stack([self.data[s:s + S + 1] for s in starts]) \
            .astype(np.int32) % self.vocab
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def batch_iterator(cfg: ArchConfig, shape: Shape, dc: DataConfig,
                   start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    corpus = None
    if dc.corpus_path and os.path.exists(dc.corpus_path):
        corpus = MemmapCorpus(dc.corpus_path, cfg.vocab)
    step = start_step
    while True:
        if corpus is not None:
            yield corpus.batch(shape.global_batch, shape.seq_len, step,
                               dc.seed)
        else:
            yield synthetic_batch(cfg, shape, step, dc)
        step += 1


def batch_axes(cfg: ArchConfig) -> Dict[str, tuple]:
    """The logical axes of a training batch's entries (the reference's
    ``launch/cells.py`` ``batch_specs``): tokens and labels over (batch,
    seq), codebooks replicated, a patch prefix over batch only."""
    if cfg.n_codebooks:
        return {"tokens": ("batch", "seq", None),
                "labels": ("batch", "seq", None)}
    return {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
            "patches": ("batch", None, None)}


def make_global_batch(host_batch, shardings):
    """Place host arrays on the mesh (name -> NamedSharding): each rank
    keeps its slice of the batch it holds whole."""
    return {k: distribute(torch.as_tensor(v), shardings[k])
            for k, v in host_batch.items()}
