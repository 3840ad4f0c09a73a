"""qwen3-moe-235b-a22b [hf:Qwen]: MoE 128 experts top-8, GQA kv=4, qk-norm."""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab=151936, mlp="swiglu", head_dim=128, qk_norm=True,
    moe=MoEConfig(n_experts=128, top_k=8, expert_d_ff=1536),
)
