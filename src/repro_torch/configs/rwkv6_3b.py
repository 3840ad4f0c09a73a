"""rwkv6-3b "Finch" [arXiv:2404.05892]: attention-free, data-dependent
decay.  O(1) decode state: eligible for long_500k."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=8960, vocab=65536, block_pattern=("rwkv",),
    rwkv_head_dim=64,
)
