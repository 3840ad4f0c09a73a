"""The coherency core on tensors: protocol tables and their envelope
checks, transport, agents, the two-node directory and engine
(``directory``, ``engine``), the sharer-vector directory and the N-remote
engine (see ``engine_mn``), protocol subsetting (``specialize``), the
application-facing store (``coherent_store``) and distributed operator
pushdown (``pushdown``)."""
from .coherent_store import CoherentStore  # noqa: F401
from .engine import Engine  # noqa: F401
from .engine_mn import EngineMN, EngineMNState, step_mn  # noqa: F401
from .messages import MsgType  # noqa: F401
from .multinode import MultiNodeRef  # noqa: F401
from .protocol import (ENHANCED_MESI, FULL, FULL_MOESI,  # noqa: F401
                       MINIMAL, MN_FULL, MN_MINIMAL, READ_ONLY, STATELESS,
                       SUBSETS, LocalOp, verify_envelope,
                       verify_envelope_mn)
from .specialize import subset_metrics, subset_metrics_mn  # noqa: F401
from .states import HomeState, RemoteState  # noqa: F401
