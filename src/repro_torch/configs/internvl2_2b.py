"""internvl2-2b [vlm]: InternViT + InternLM2 decoder backbone.

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.  The InternViT
frontend is a STUB: input_specs() provides precomputed, already-projected
patch embeddings which are concatenated in front of the token embeddings.
[arXiv:2404.16821; hf]
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab=92553, n_patches=1024,
)
