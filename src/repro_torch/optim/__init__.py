from .adamw import OptimConfig, OptState, init, update, schedule  # noqa
from . import compression  # noqa
