"""smollm-360m [hf:HuggingFaceTB/SmolLM-360M]: small llama-arch, GQA kv=5."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab=49152, mlp="swiglu", tie_embeddings=True,
)
