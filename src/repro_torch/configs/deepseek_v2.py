"""deepseek-v2-236b [moe]: Multi-head Latent Attention + fine-grained MoE.

60L d_model=5120 128H (MLA kv_lora=512) d_ff_expert=1536 vocab=102400,
2 shared + 160 routed experts, top-6.  MLA caches the compressed latent
(c_kv 512 + shared rope key 64) — the serve path uses the absorbed-matmul
decode form.  [arXiv:2405.04434; hf]
"""

from .base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=1536, vocab=102400,
    pattern=("mla",), ffn_pattern=("moe",),
    moe=MoEConfig(n_experts=160, top_k=6, d_ff_expert=1536, n_shared=2),
    mla=MLAConfig(kv_lora=512, q_lora=1536, d_rope=64, d_nope=128, d_v=128),
    d_head=192,   # d_nope + d_rope
)
