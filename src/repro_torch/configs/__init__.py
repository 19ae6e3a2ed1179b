"""configs — the 10 assigned architectures + the 4 input shapes.

``get_config(name)`` returns the exact published configuration;
``get_config(name, reduced=True)`` the small same-family smoke variant.
"""

from __future__ import annotations

from typing import Dict, List

from .base import ArchConfig, MLAConfig, MoEConfig, SHAPES, Shape, \
    supported_shapes

from . import (musicgen_large, smollm_135m, yi_34b, llama32_3b, granite_3_8b,
               xlstm_125m, internvl2_2b, phi35_moe, deepseek_v2, jamba_52b)

ARCHS: Dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (musicgen_large, smollm_135m, yi_34b, llama32_3b, granite_3_8b,
              xlstm_125m, internvl2_2b, phi35_moe, deepseek_v2, jamba_52b)
}

# short aliases for --arch flags
ALIASES = {
    "musicgen-large": "musicgen-large",
    "smollm-135m": "smollm-135m",
    "yi-34b": "yi-34b",
    "llama3.2-3b": "llama3.2-3b",
    "granite-3-8b": "granite-3-8b",
    "xlstm-125m": "xlstm-125m",
    "internvl2-2b": "internvl2-2b",
    "phi3.5-moe": "phi3.5-moe-42b-a6.6b",
    "phi3.5-moe-42b-a6.6b": "phi3.5-moe-42b-a6.6b",
    "deepseek-v2": "deepseek-v2-236b",
    "deepseek-v2-236b": "deepseek-v2-236b",
    "jamba-v0.1-52b": "jamba-v0.1-52b",
    "jamba": "jamba-v0.1-52b",
}


def get_config(name: str, reduced: bool = False) -> ArchConfig:
    cfg = ARCHS[ALIASES.get(name, name)]
    return cfg.reduced() if reduced else cfg


def all_cells() -> List[tuple]:
    """Every runnable (arch, shape) cell (32 cells; 8 documented skips)."""
    cells = []
    for name, cfg in ARCHS.items():
        for shape in supported_shapes(cfg):
            cells.append((name, shape))
    return cells


__all__ = ["ArchConfig", "MLAConfig", "MoEConfig", "SHAPES", "Shape",
           "ARCHS", "ALIASES", "get_config", "all_cells", "supported_shapes"]
