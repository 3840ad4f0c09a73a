"""chameleon-34b [arXiv:2405.09818]: early-fusion VLM — the transformer
backbone is a dense GQA decoder with qk-norm over a unified token space;
the VQ image tokenizer is a STUB (input_specs supplies token ids)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=65536, mlp="swiglu", qk_norm=True,
)
