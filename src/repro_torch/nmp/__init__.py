"""Near-memory-processing operators (paper §5) on tensors: SELECT pushdown,
KVS pointer chasing and regex filtering — the three workloads ECI runs
inside its smart memory controller.  Plain PyTorch here; the CUDA kernels
of the per-shard hot loops are in ``repro_torch.kernels`` (``ops``), which
``core.pushdown`` runs."""

from .select import select_scan, make_table  # noqa: F401
from .kvstore import KVStore, build_kvs, kvs_lookup  # noqa: F401
from .regex import compile_regex  # noqa: F401
from .dfa import dfa_match  # noqa: F401
