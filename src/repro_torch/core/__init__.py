"""The coherency core on tensors: protocol tables, transport, agents, the
sharer-vector directory and the N-remote engine (see ``engine_mn``)."""
from .engine_mn import EngineMN, EngineMNState, step_mn  # noqa: F401
from .messages import MsgType  # noqa: F401
from .multinode import MultiNodeRef  # noqa: F401
from .protocol import (ENHANCED_MESI, FULL_MOESI, READ_ONLY,  # noqa: F401
                       STATELESS, SUBSETS, LocalOp)
