"""musicgen-large [audio]: decoder-only transformer over EnCodec tokens.

48L d_model=2048 32H (MHA: kv=32) d_ff=8192, 4 codebooks x vocab 2048.
The EnCodec frontend is a STUB: input_specs() provides the 4-codebook token
frame ids; frame embeddings are the sum of the 4 codebook embeddings and the
head predicts all 4 codebooks per frame.  [arXiv:2306.05284; hf]
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=2048, n_codebooks=4,
)
