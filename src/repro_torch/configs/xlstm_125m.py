"""xlstm-125m [ssm]: alternating sLSTM + mLSTM blocks.

12L d_model=768 4H (kv=4) d_ff=0 vocab=50304.  d_ff=0 means the blocks
carry their own up/down projections (expand factor 2) instead of a separate
FFN.  mLSTM is the chunkwise-parallel matrix-memory (linear-attention form)
block; sLSTM is the sequential scalar-memory block (lax.scan over sequence).
Recurrent state => sub-quadratic => runs the long_500k cell.
[arXiv:2405.04517; unverified]
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    pattern=("mlstm", "slstm"), ffn_pattern=("none", "none"),
    expand=2, subquadratic=True,
)
