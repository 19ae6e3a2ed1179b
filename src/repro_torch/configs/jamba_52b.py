"""jamba-v0.1-52b [hybrid]: Mamba + attention 1:7 interleave, MoE.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16 experts
top-2 on every other layer.  One scan period = 8 layers with attention at
position 4 (1 attn : 7 mamba) and MoE at odd positions.  Mamba state =>
sub-quadratic => runs the long_500k cell (its 4 attention layers decode
against a seq-sharded KV cache).  [arXiv:2403.19887; hf]
"""

from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=65536,
    pattern=("mamba", "mamba", "mamba", "mamba",
             "attn", "mamba", "mamba", "mamba"),
    ffn_pattern=("dense", "moe", "dense", "moe",
                 "dense", "moe", "dense", "moe"),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336),
    expand=2, d_state=16, subquadratic=True,
)
