"""Serving on one device: ``ServeEngine``, the coherent prefix tier and
weight-only int8 quantization."""
from .engine import (CoherentPrefixTier, ServeEngine,  # noqa: F401
                     decode_state_specs, make_serve_step)
from .quantize import quantize_params  # noqa: F401
