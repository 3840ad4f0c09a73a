"""The coherency core on tensors: protocol tables and their envelope
checks, transport, agents, the sharer-vector directory and the N-remote
engine (see ``engine_mn``), protocol subsetting (``specialize``) and
distributed operator pushdown (``pushdown``)."""
from .engine_mn import EngineMN, EngineMNState, step_mn  # noqa: F401
from .messages import MsgType  # noqa: F401
from .multinode import MultiNodeRef  # noqa: F401
from .protocol import (ENHANCED_MESI, FULL_MOESI, READ_ONLY,  # noqa: F401
                       STATELESS, SUBSETS, LocalOp, verify_envelope,
                       verify_envelope_mn)
from .specialize import subset_metrics, subset_metrics_mn  # noqa: F401
