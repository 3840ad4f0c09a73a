"""whisper-small [arXiv:2212.04356]: encoder-decoder backbone; the conv
audio frontend is a STUB (input_specs supplies precomputed frame
embeddings, 1500 frames)."""
from ..models.config import ModelConfig, EncoderConfig

CONFIG = ModelConfig(
    name="whisper-small", family="encdec",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865, mlp="gelu",
    encoder=EncoderConfig(n_layers=12, n_frames=1500),
)
