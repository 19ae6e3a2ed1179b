"""Find a cell's pieces by name: ``BENCHMARK.json``'s entries, the
configuration file it names, the traffic mix ``bench/traffic/<name>.json``
(all under the checkout's root).

A configuration file holds its model's published ``config.json`` keys
(cut where ``reduced`` says), with ``published`` giving the source's value
of each cut key, ``assumed`` what the port computes where it departs from
the published model, and ``run`` the dtypes and the deployment's knobs.
The harness builds one family, a decoder of attention layers with a dense
or a mixture-of-experts FFN (``program.arch_config``); a file with a key
it does not know, or a value of ``hidden_act`` or ``model_type`` it does
not build, is refused, so that another family (latent attention, a scan)
fails loudly instead of running as the wrong model.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

@dataclass(frozen=True)
class ModelSpec:
    """The shapes and dtypes the benchmark reads from a configuration."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    tie_embeddings: bool
    norm_eps: float
    rope_theta: float
    param_dtype: str
    compute_dtype: str
    logits_dtype: str
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    norm_init_std: float = 0.1
    embed_init_std: float = 0.02
    residual_init_scale: float = 1.0


# the keys a configuration file may hold: those read into ``ModelSpec``,
# and the source's record that the reading does not need (each departure
# from it is written under ``assumed``)
READ = {"name", "num_hidden_layers", "hidden_size", "num_attention_heads",
        "num_key_value_heads", "head_dim", "intermediate_size",
        "vocab_size", "tie_word_embeddings", "rms_norm_eps", "rope_theta",
        "num_local_experts", "num_experts_per_tok", "run"}
RECORD = {"source", "reduced", "published", "deployment", "assumed",
          "architectures", "model_type", "torch_dtype", "hidden_act",
          "max_position_embeddings", "original_max_position_embeddings",
          "sliding_window", "attention_bias", "lm_head_bias"}
RUN = {"param_dtype", "compute_dtype", "logits_dtype",
       "optimizer_state_dtype", "capacity_factor", "norm_init_std",
       "embed_init_std", "residual_init_scale"}
BUILT = {"hidden_act": {"silu"}, "model_type": {"llama", "phimoe"}}


def model_spec(cfg: dict) -> ModelSpec:
    """A ``ModelSpec`` from a configuration file's contents; raises
    ``ValueError`` on a key or a value the harness does not build."""
    unknown = sorted(set(cfg) - READ - RECORD) \
        + sorted(f"run.{k}" for k in set(cfg.get("run", {})) - RUN)
    if unknown:
        raise ValueError(f"configuration {cfg.get('name')!r}: keys the "
                         f"harness does not build: {unknown}")
    for k, ok in BUILT.items():
        if k in cfg and cfg[k] not in ok:
            raise ValueError(f"configuration {cfg.get('name')!r}: {k} "
                             f"{cfg[k]!r} is not built (only {sorted(ok)})")
    run = cfg["run"]
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    E = cfg.get("num_local_experts", 0)
    return ModelSpec(
        name=cfg["name"], n_layers=cfg["num_hidden_layers"], d_model=D,
        n_heads=H, n_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg.get("head_dim") or D // H,
        d_ff=0 if E else cfg["intermediate_size"],
        vocab=cfg["vocab_size"],
        tie_embeddings=cfg["tie_word_embeddings"],
        norm_eps=cfg["rms_norm_eps"], rope_theta=cfg["rope_theta"],
        param_dtype=run["param_dtype"], compute_dtype=run["compute_dtype"],
        logits_dtype=run["logits_dtype"], n_experts=E,
        top_k=cfg.get("num_experts_per_tok", 0),
        d_ff_expert=cfg["intermediate_size"] if E else 0,
        capacity_factor=run.get("capacity_factor", 1.25),
        norm_init_std=run["norm_init_std"],
        embed_init_std=run.get("embed_init_std", 0.02),
        residual_init_scale=run.get("residual_init_scale", 1.0))


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with its configuration and traffic."""

    name: str
    chips: int
    spec: ModelSpec
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
    return Cell(name, w["chips"], model_spec(cfg), traffic, root)


def cell_metrics(name: str, root: Path, trace: bool) -> list:
    """The metric entries a run of cell ``name`` reports: with ``trace``
    its per-layer metrics, else its end-to-end ones (those without a
    ``workloads`` key, or that list it)."""
    bench = _read(root / "BENCHMARK.json")
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key] if name in m.get("workloads", [name])]
