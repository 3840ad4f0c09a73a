"""Model substrate of the port: the layer library and the assembly of the
dense, gemma2, chameleon and recurrentgemma decoders (block kinds ``ga``,
``la``, ``rg``), with ``configs/`` naming the published configs."""

from .config import EncoderConfig, ModelConfig, MoEConfig  # noqa: F401
from .transformer import (decode_step, forward, init_decode_state,  # noqa
                          init_params)
