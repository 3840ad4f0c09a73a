"""granite-3.0-1b-a400m [hf:ibm-granite]: MoE, 32 experts top-8."""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=512, vocab=49155, mlp="swiglu", tie_embeddings=True,
    moe=MoEConfig(n_experts=32, top_k=8, expert_d_ff=512),
)
