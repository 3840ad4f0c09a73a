"""gemma2-9b [arXiv:2408.00118]: alternating local/global attention,
attention + final-logit soft-capping, GQA kv=8, tied embeddings."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8,
    d_ff=14336, vocab=256000, mlp="swiglu", head_dim=256,
    attn_softcap=50.0, logit_softcap=30.0, window=4096,
    block_pattern=("la", "ga"), tie_embeddings=True,
)
