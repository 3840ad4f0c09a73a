"""Serving: a batched generation engine with an ECI-coherent prefix-reuse
tier.

The port of ``repro.serve.engine`` on one device.  ``ServeEngine`` feeds
prompts and greedy tokens through ``models.decode_step`` one position at
a time.  ``CoherentPrefixTier`` is the paper's Fig. 8 at the serving
layer: decode states of hot prompt prefixes are published through a
``CoherentStore`` on the READ_ONLY subset; the store's lines carry
metadata (pool slot + fingerprint) and the decode states stay in a local
pool.

The port's decode writes KV caches and ring buffers IN PLACE, where JAX
arrays are immutable; so ``prefill`` and ``decode`` copy the state they
are given once on entry (one copy a call, not a token), and a state the
tier hands out any number of times stays as it was published.

The mesh paths (``mesh=``, ``decode_state_specs``, ``make_serve_step``)
shard over ``launch/sharding.py``, which is not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import READ_ONLY, CoherentStore
from ..device import resolve_device
from ..models import decode_step, init_decode_state
from ..models.config import ModelConfig

#: the ROADMAP item that ports the mesh paths (``launch/sharding.py``).
MESH_ITEM = "ROADMAP Queue 1 item 17b (launch/sharding.py)"


def decode_state_specs(*args, **kwargs):
    raise NotImplementedError(f"decode_state_specs: {MESH_ITEM}")


def make_serve_step(*args, **kwargs):
    raise NotImplementedError(f"make_serve_step: {MESH_ITEM}")


def _copy_state(state: List[Dict[str, torch.Tensor]]
                ) -> List[Dict[str, torch.Tensor]]:
    return [{k: v.clone() for k, v in layer.items()} for layer in state]


class ServeEngine:
    """Small batched generation engine on one device (``device`` defaults
    to ``"cuda"``; with no GPU present that raises — pass
    ``device="cpu"``).  ``params`` lie on that device, dense or quantized
    (``serve.quantize``)."""

    def __init__(self, cfg: ModelConfig, params, max_seq: int = 128,
                 mesh=None, device=None):
        if mesh is not None:
            raise NotImplementedError(f"mesh serving: {MESH_ITEM}")
        self.device = resolve_device(device)
        self.cfg, self.params, self.max_seq = cfg, params, max_seq

    def prefill(self, prompts: torch.Tensor, state=None,
                start_index: int = 0) -> Tuple[Any, int, torch.Tensor]:
        """Feed prompt tokens [B, S0]; returns (state, next_index,
        last_logits).  A given ``state`` is copied, not written."""
        B, S0 = prompts.shape
        state = (init_decode_state(self.cfg, B, self.max_seq, self.device)
                 if state is None else _copy_state(state))
        idx, lg = start_index, None
        for t in range(S0):
            lg, state = decode_step(self.params, self.cfg, prompts[:, t],
                                    idx, state)
            idx += 1
        return state, idx, lg

    def decode(self, state, first_token: torch.Tensor, index: int,
               n_new: int) -> Tuple[torch.Tensor, Any]:
        """Greedy decode of ``n_new`` tokens from ``first_token`` [B]
        (the first of them): ([B, n_new] int32, final state).  ``state``
        is copied, not written."""
        state = _copy_state(state)
        tok = first_token.to(torch.int32)
        out = []
        for _ in range(n_new):
            out.append(tok)
            lg, state = decode_step(self.params, self.cfg, tok, index,
                                    state)
            index += 1
            tok = lg.argmax(-1).to(torch.int32)
        return torch.stack(out, dim=1), state

    def generate(self, prompts: torch.Tensor, n_new: int
                 ) -> Tuple[torch.Tensor, Any]:
        """prompts [B, S0]; returns ([B, n_new], final_state)."""
        state, idx, lg = self.prefill(prompts)
        return self.decode(state, lg.argmax(-1), idx, n_new)


class CoherentPrefixTier:
    """Prefix-reuse tier over the ECI stack (paper Fig. 8 for serving).

    Lines are (slot + 1, fingerprint) records in a ``CoherentStore`` on
    the READ_ONLY subset: readers only LOAD/EVICT, and ``publish`` is a
    home-side write whose home-initiated downgrade-to-invalid invalidates
    each reader's cached copy.  A lookup of a hot prefix hits the
    reader's coherent cache with no interconnect traffic.

    ``n_readers > 1`` runs the store on the N-remote engine: each reader
    has a coherent cache of its own, and a ``publish`` fans out one
    invalidation per reader that holds the line.  ``device`` defaults to
    ``"cuda"``."""

    def __init__(self, n_lines: int = 256, n_readers: int = 1,
                 device=None):
        dev = resolve_device(device)
        backing = torch.zeros((n_lines, 2), dtype=torch.float32,
                              device=dev)             # (slot + 1, fp)
        self.store = CoherentStore(backing, READ_ONLY, n_remotes=n_readers,
                                   device=dev)
        self.pool: Dict[int, Any] = {}
        self.n_lines = n_lines
        self.n_readers = n_readers
        self._next_slot = 0

    def _line_of(self, prefix) -> Tuple[int, float]:
        # Python ints: a tuple of them hashes the same in every process,
        # where a tuple of tensors would hash by identity.
        h = hash(tuple(int(t) for t in prefix)) & 0x7FFFFFFF
        return h % self.n_lines, float(h % (1 << 20))

    def publish(self, prefix, state: Any) -> None:
        line, fp = self._line_of(prefix)
        slot = self._next_slot
        self._next_slot += 1
        self.pool[slot] = state
        # home-side write: invalidates every reader's copy coherently (one
        # HOME_DOWNGRADE_I per sharer on the N-remote engine).
        self.store.home_write([line], np.asarray([[slot + 1.0, fp]],
                                                 np.float32))

    def lookup(self, prefix, reader: int = 0) -> Optional[Any]:
        line, fp = self._line_of(prefix)
        rec = self.store.read([line], node=reader)[0].cpu().numpy()
        if rec[0] >= 1.0 and rec[1] == fp:
            return self.pool.get(int(rec[0]) - 1)
        return None

    @property
    def hit_rate(self) -> float:
        h, m = self.store.hits, self.store.misses
        return h / max(h + m, 1)
