"""Find a cell's pieces by name: ``BENCHMARK.json``'s entries, the
configuration file it names, the traffic mix ``bench/traffic/<name>.json``
and the configuration's family ``bench/families/<model_type>.py`` (all
under the checkout's root).

A configuration file holds its model's published ``config.json`` keys
(cut where ``reduced`` says), with ``published`` giving the source's value
of each cut key, ``assumed`` what the port computes where it departs from
the published model, and ``run`` the dtypes and the deployment's knobs.
Its ``model_type`` picks its family, a file of its own
(``bench/families/__init__.py`` says what the file provides), which reads
the configuration into the run's spec and knows the program's
configuration, the weights' layout, the plain reference and the work
counts.  A ``model_type`` with no such file is not built; a key that
neither the shared sets below nor the family reads, or a value the family
does not build, is refused: a configuration runs as the model it states or
not at all.  A new family is a new file and needs no edit here.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path

from . import families

ROOT = Path(__file__).resolve().parents[1]

# the keys every configuration file may hold, whatever its family: its
# name, its run knobs (``RUN``), and the source's record that no reading
# needs (each departure from it is written under ``assumed``)
RECORD = {"name", "run", "source", "reduced", "published", "deployment",
          "assumed", "architectures", "model_type", "torch_dtype",
          "hidden_act", "max_position_embeddings",
          "original_max_position_embeddings", "sliding_window",
          "attention_bias", "lm_head_bias"}
RUN = {"param_dtype", "compute_dtype", "logits_dtype",
       "optimizer_state_dtype", "capacity_factor", "norm_init_std",
       "embed_init_std", "residual_init_scale"}


def model_spec(cfg: dict, root: Path = ROOT):
    """The run's spec from a configuration file's contents, read by its
    family under ``root``; raises ``ValueError`` on a ``model_type``, a key
    or a value the harness does not build."""
    fam = families.load(cfg.get("model_type"), root)
    unknown = sorted(set(cfg) - RECORD - fam.READ) \
        + sorted(f"run.{k}" for k in set(cfg.get("run", {})) - RUN)
    if unknown:
        raise ValueError(f"configuration {cfg.get('name')!r}: keys the "
                         f"harness does not build: {unknown}")
    for k, ok in getattr(fam, "BUILT", {}).items():
        if k in cfg and cfg[k] not in ok:
            raise ValueError(f"configuration {cfg.get('name')!r}: {k} "
                             f"{cfg[k]!r} is not built (only {sorted(ok)})")
    return dataclasses.replace(fam.spec(cfg), family=fam)


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with its configuration and traffic."""

    name: str
    chips: int
    spec: object        # its family's spec
    traffic: dict
    root: Path


def load_cell(name: str, root: Path) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``.  Raises ``KeyError``
    for a name it does not list and ``FileNotFoundError`` for a piece that
    is missing."""
    bench = _read(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    configs = {c["name"]: c for c in bench["configs"]}
    w = cells[name]
    cfg = _read(root / configs[w["config"]]["file"])
    traffic = _read(root / "bench" / "traffic" / f"{w['traffic']}.json")
    return Cell(name, w["chips"], model_spec(cfg, root), traffic, root)


def cell_metrics(name: str, root: Path, trace: bool) -> list:
    """The metric entries a run of cell ``name`` reports: with ``trace``
    its per-layer metrics, else its end-to-end ones (those without a
    ``workloads`` key, or that list it)."""
    bench = _read(root / "BENCHMARK.json")
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key] if name in m.get("workloads", [name])]
