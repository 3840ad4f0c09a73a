"""recurrentgemma-9b [arXiv:2402.19427]: Griffin — RG-LRU recurrent blocks
with local attention 1:2 (pattern rg,rg,la), 38 layers = 12x3 + 2-layer
tail (rg,rg).  Sub-quadratic: eligible for long_500k."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab=256000, mlp="swiglu", head_dim=256,
    window=2048, block_pattern=("rg", "rg", "la"),
    tail_pattern=("rg", "rg"), tie_embeddings=True,
)
