"""nemotron-4-340b [arXiv:2402.16819]: dense GQA decoder, squared-ReLU MLP."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8,
    d_ff=73728, vocab=256000, mlp="relu2",
)
