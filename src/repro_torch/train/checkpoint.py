"""Checkpoint/restart with elastic resharding, in the JAX package's on-disk
format (port of ``repro.train.checkpoint``).

A checkpoint is ``step_%010d/`` holding ``arrays.npz`` and
``manifest.json`` (step, keys, shapes, dtypes, extra), each array keyed by
its ``/``-joined dict path with ``/`` written as ``__``, the paths in the
reference's order (``jax.tree_util`` flattens a dict in sorted key order).
Writes are atomic (a tmp dir, then ``rename``) and a retention policy
prunes old steps.  ``latest_step`` enables auto-resume.

The arrays are the JAX layout: with ``cfg``, every subtree that is a
parameter tree of that configuration (the parameters, and AdamW's ``m``
and ``v``) is written through ``models.convert.params_to_jax`` and read
back through ``params_from_jax``.  So a checkpoint that either package
writes restores in the other.  ``restore`` takes a ``like`` tree of the
port's tensors (``meta`` tensors will do), checks every shape, and
places the result on ``device`` (default: each ``like`` leaf's own;
``meta`` tensors need ``device``), or, with ``shardings`` (a
same-structure tree of ``parallel.sharding.NamedSharding``), onto the
current mesh: a run saved on one mesh restores onto any other (elastic
scaling).

A tree of DTensors is saved whole: every rank gathers each leaf (a
collective, so every rank calls ``save``), rank 0 alone writes, and a
barrier follows, so that no rank reads ``latest_step`` before the write.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..configs.base import ArchConfig
from ..device import DeviceLike
from ..models.convert import params_from_jax, params_to_jax
from ..models.model import spec_tree
from ..parallel.sharding import gather, place


def _is_params(tree, cfg: Optional[ArchConfig]) -> bool:
    return (cfg is not None and isinstance(tree, dict)
            and set(tree) == set(spec_tree(cfg)))


def _flatten(tree, path=()) -> List[Tuple[str, Any]]:
    """[("/"-joined path, leaf)] in sorted key order at every level."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flatten(tree[k], path + (str(k),))]
    return [("/".join(path), tree)]


def _to_jax(tree, cfg):
    """``tree`` with every parameter subtree in the JAX layout and every
    leaf a host numpy array."""
    if _is_params(tree, cfg):
        return params_to_jax(tree, cfg)
    if isinstance(tree, dict):
        return {k: _to_jax(v, cfg) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def _multi_rank() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def save(ckpt_dir: str, step: int, tree, *, cfg: Optional[ArchConfig] = None,
         keep: int = 3, extra: Optional[Dict] = None) -> str:
    """Atomically write checkpoint ``step``; prune to ``keep`` newest.  In a
    process group of several ranks every rank calls it and rank 0
    writes."""
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tree = gather(tree)
    if _multi_rank():
        if dist.get_rank() == 0:
            _write(ckpt_dir, step, tree, cfg, keep, extra)
        dist.barrier()
        return final
    return _write(ckpt_dir, step, tree, cfg, keep, extra)


def _write(ckpt_dir, step, tree, cfg, keep, extra) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(_to_jax(tree, cfg))
    arrays = {k: np.asarray(v) for k, v in flat}
    manifest = {
        "step": int(step),
        "keys": [k for k, _ in flat],
        "shapes": {k: list(a.shape) for k, a in arrays.items()},
        "dtypes": {k: str(a.dtype) for k, a in arrays.items()},
        "extra": extra or {},
    }
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k.replace("/", "__"): a for k, a in arrays.items()})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _prune(ckpt_dir, keep)
    return final


def _prune(ckpt_dir: str, keep: int):
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.startswith(".tmp"):
            try:
                out.append(int(d[len("step_"):]))
            except ValueError:
                pass
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return max(steps) if steps else None


def _read(npz, like, path, cfg, device):
    """The ``like``-shaped subtree at ``path`` from the npz file."""
    if _is_params(like, cfg):
        jax_tree = {g: {nm: npz["__".join(path + (g, nm))] for nm in sub}
                    for g, sub in like.items()}
        got = params_from_jax(jax_tree, cfg, device="cpu")
        return {g: {nm: _place(got[g][nm], like[g][nm], path + (g, nm),
                               device)
                    for nm in sub} for g, sub in like.items()}
    if isinstance(like, dict):
        return {k: _read(npz, v, path + (str(k),), cfg, device)
                for k, v in like.items()}
    return _place(torch.from_numpy(np.array(npz["__".join(path)])), like,
                  path, device)


def _place(t: torch.Tensor, like: torch.Tensor, path, device):
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {'/'.join(path)}: "
                         f"{tuple(t.shape)} != {tuple(like.shape)}")
    return t.to(device=like.device if device is None else device,
                dtype=like.dtype)


def restore(ckpt_dir: str, step: int, like, *,
            cfg: Optional[ArchConfig] = None, device: DeviceLike = None,
            shardings=None):
    """Restore into the structure of ``like`` (a tree of tensors, whose
    shapes and dtypes are the port's).  ``shardings``: a same-structure
    tree of NamedSharding for elastic placement onto the current mesh
    (every rank reads the checkpoint and keeps its slices); None = tensors
    on ``device``.  Returns (tree, manifest)."""
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        tree = _read(npz, like, (), cfg,
                     "cpu" if shardings is not None else device)
    if shardings is not None:
        tree = place(tree, shardings)
    return tree, manifest
