"""Production-scale configuration search over dry-run rooflines (port of
``repro.tune.dryrun_search``).

Enumerates (sharding variant x grad_accum x remat x chunk) points for one
(arch x shape) cell, traces each on the production mesh
(``launch/dryrun.py``: fake tensors over a fake group), scores it by the
dominant roofline term against an H100's peaks, and returns the ranked
table.  Each evaluation is a trace, so the search space is kept small and
every result is cached to disk, with the reference's file names, record
fields (``trace_s`` for ``compile_s``; ``live_bytes`` the traced peak) and
sort key.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence

import torch

from ..kernels.cost import CARD_MEMORY_BYTES
from ..launch.cells import DRYRUN_KNOBS, build_cell
from ..launch.mesh import fake_world, make_production_mesh, production_size
from ..launch.trace_cost import roofline_terms
from ..models.model import ModelKnobs
from ..train.step import TrainConfig


@dataclass
class SearchPoint:
    """One configuration.  ``scan_unroll`` has no counterpart in the port
    (its periods run as an eager loop, and its ``ModelKnobs`` has no such
    field): the field is kept, in the record too, and the port's score
    ignores it."""

    name: str
    variant: str = "cp"
    grad_accum: int = 4
    remat: str = "full"
    kv_chunk: int = 512
    ssm_chunk: int = 256
    moe_dispatch: str = "a2a"
    scan_unroll: int = 1
    accum_dtype: str = "float32"

    def knobs(self) -> ModelKnobs:
        return replace(DRYRUN_KNOBS, kv_chunk=self.kv_chunk,
                       ssm_chunk=self.ssm_chunk, remat=self.remat,
                       moe_dispatch=self.moe_dispatch)

    def tc(self) -> TrainConfig:
        return TrainConfig(grad_accum=self.grad_accum,
                           accum_dtype=getattr(torch, self.accum_dtype))


def evaluate_point(arch: str, shape: str, pt: SearchPoint, *,
                   multi_pod: bool = False,
                   cache_dir: Optional[str] = None) -> Dict:
    tag = f"{arch}_{shape}_{pt.name}_{'multi' if multi_pod else 'single'}"
    if cache_dir:
        path = os.path.join(cache_dir, tag + ".json")
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
    with fake_world(production_size(multi_pod)):
        mesh = make_production_mesh(multi_pod=multi_pod)
        cell = build_cell(arch, shape, mesh, variant=pt.variant,
                          knobs=pt.knobs(), tc=pt.tc())
        _, tr = cell.trace()
    coll = tr.collectives
    terms = roofline_terms(tr.cost.flops, tr.cost.bytes, coll.total_bytes)
    live = tr.peak_bytes
    rec = {
        "tag": tag, "arch": arch, "shape": shape,
        "point": pt.__dict__, "trace_s": round(tr.trace_s, 1),
        "roofline": terms,
        "live_bytes": int(live), "fits": bool(live <= CARD_MEMORY_BYTES),
        "collective_by_kind": coll.bytes_by_kind,
    }
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def dryrun_search(arch: str, shape: str, points: Sequence[SearchPoint], *,
                  multi_pod: bool = False, cache_dir: Optional[str] = None,
                  require_fit: bool = True) -> List[Dict]:
    """Evaluate all points, return records sorted by roofline step time
    (unfitting points sorted last)."""
    recs = []
    for pt in points:
        try:
            recs.append(evaluate_point(arch, shape, pt,
                                       multi_pod=multi_pod,
                                       cache_dir=cache_dir))
        except Exception as e:  # trace failures are real search results
            recs.append({"tag": f"{arch}_{shape}_{pt.name}",
                         "point": pt.__dict__, "error": repr(e)})

    def key(r):
        if "error" in r:
            return (2, float("inf"))
        bad = require_fit and not r["fits"]
        return (1 if bad else 0, r["roofline"]["step_s"])
    return sorted(recs, key=key)
