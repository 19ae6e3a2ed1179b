"""A checkout root in a temporary directory holding tiny cells of the
benchmark's two families, with the benchmark's own code and readers, for
runs on the CPU (the program's plain versions)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

MOE = {"name": "tiny-moe", "source": "test", "reduced": [], "published": {},
       "model_type": "phimoe", "hidden_size": 64, "intermediate_size": 48,
       "num_attention_heads": 4, "num_key_value_heads": 2,
       "num_hidden_layers": 2, "num_local_experts": 4,
       "num_experts_per_tok": 2, "vocab_size": 128, "rms_norm_eps": 1e-5,
       "rope_theta": 10000.0, "tie_word_embeddings": False,
       "run": {"param_dtype": "float32", "compute_dtype": "float32",
               "logits_dtype": "float32", "capacity_factor": 2.0,
               "norm_init_std": 0.1}}
DENSE = {"name": "tiny-dense", "source": "test", "reduced": [],
         "published": {}, "model_type": "llama", "hidden_size": 48,
         "intermediate_size": 96, "num_attention_heads": 3,
         "num_key_value_heads": 1, "num_hidden_layers": 3, "vocab_size": 96,
         "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
         "tie_word_embeddings": True,
         "run": {"param_dtype": "float32", "compute_dtype": "float32",
                 "logits_dtype": "float32", "norm_init_std": 0.1}}
OPT = {"lr": 3e-2, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1,
       "clip_norm": 1.0, "warmup": 2, "decay_steps": 100,
       "min_lr_ratio": 0.1}
TRAFFIC = {
    "tiny-train": {"kind": "train", "batch": 4, "seq": 16, "grad_accum": 2,
                   "remat": "full",
                   "optimizer": OPT},
    "tiny-serve": {"kind": "serve", "loop": "closed", "clients": 6,
                   "slots": 4, "s_max": 48,
                   "prompt": {"dist": "loguniform", "min": 8, "max": 24},
                   "output": {"dist": "uniform", "min": 3, "max": 8},
                   "warmup_completions": 4},
    "tiny-open": {"kind": "serve", "loop": "open",
                  "arrival": {"dist": "exponential", "rate": 40.0,
                              "strata": 8}, "slots": 4,
                  "s_max": 48,
                  "prompt": {"dist": "loguniform", "min": 8, "max": 24},
                  "output": {"dist": "uniform", "min": 3, "max": 8},
                  "warmup_completions": 4},
}
CELLS = [("moe-train", "tiny-moe", "tiny-train"),
         ("dense-train", "tiny-dense", "tiny-train"),
         ("moe-serve", "tiny-moe", "tiny-serve"),
         ("moe-open", "tiny-moe", "tiny-open")]


def make_root(tmp: Path, limits: dict = None) -> Path:
    """A checkout root under ``tmp``: BENCHMARK.json listing ``CELLS``
    with the benchmark's real metrics, and each cell's limits."""
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    root = tmp / "root"
    shutil.copytree(BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cfg in (MOE, DENSE):
        (root / "bench" / "configs" / f"{cfg['name']}.json").write_text(
            json.dumps(cfg))
    for name, t in TRAFFIC.items():
        (root / "bench" / "traffic" / f"{name}.json").write_text(
            json.dumps(t))
    bench["configs"] = [{"name": c["name"], "source": "test",
                         "file": f"bench/configs/{c['name']}.json",
                         "reduced": [], "why": "test"} for c in (MOE, DENSE)]
    bench["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1,
                           "why": "test"} for n, c, t in CELLS]
    # each metric in the tiny cells of the kind of the real cells it lists
    real = {w["name"]: w["traffic"] for w in json.loads(
        (BENCH.parent / "BENCHMARK.json").read_text())["workloads"]}
    like = {"train": ["moe-train", "dense-train"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            loops = {json.loads((BENCH / "traffic" / f"{real[w]}.json")
                                .read_text()).get("loop", "train")
                     for w in m["workloads"]}
            m["workloads"] = sorted(
                {c for lp in loops for c in like.get(lp, [])}
                | ({"moe-serve"} if "closed" in loops else set())
                | ({"moe-open"} if "open" in loops else set()))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for n, _, _ in CELLS:
        (root / "bench" / "limits" / f"{n}.json").write_text(
            json.dumps((limits or {}).get(n, {})))
    return root
