"""Model substrate of the port: the layer library and the assembly of
every family of the configs (dense, gemma2, chameleon, recurrentgemma,
MoE, RWKV6 and the whisper encoder-decoder) for prefill, decode and the
training loss, with ``configs/`` naming the published configs."""

from .config import EncoderConfig, ModelConfig, MoEConfig  # noqa: F401
from .transformer import (cross_kv, decode_step, encode, forward,  # noqa
                          forward_hidden, init_decode_state, init_params,
                          loss_fn)
