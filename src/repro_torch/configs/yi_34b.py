"""yi-34b [dense]: llama-architecture GQA model.

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
[arXiv:2403.04652; hf]
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="yi-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000,
)
