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

``make_serve_step`` is the decode step sharded over a mesh: the weights
in the serving layout (replicated over ``data``, TP over ``model``), the
batch and the decode state over the data-parallel axes, the KV caches'
heads (or sequence) over ``model`` (``decode_state_specs``).  Each step
runs ``decode_step`` on this rank's rows, shards and cache blocks
(``launch.sharding.TPContext``): no weight and no cache is gathered; the
activations are summed over ``model`` after each row-parallel product,
and only the logits' vocab blocks are gathered at the end.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..core import READ_ONLY, CoherentStore
from ..device import resolve_device
from ..launch import sharding as sh
from ..models import decode_step, init_decode_state
from ..models.config import ModelConfig
from ..tree import tree_map


def decode_state_specs(cfg: ModelConfig, mesh, state,
                       shard_batch: bool = True) -> Any:
    """Specs for a decode state (the port's, one state per layer): KV
    caches and ring buffers [B, Hkv, S, hd] take ``kv_cache_spec``;
    recurrent states shard the batch over the data-parallel axes.  With
    ``shard_batch=False`` (a global batch the DP degree does not divide)
    the batch replicates and only the model axis shards."""
    def spec_of(path, leaf):
        name = str(path[-1])
        if name in ("k", "v") and leaf.ndim >= 4:
            spec = sh.kv_cache_spec(mesh, cfg.n_kv_heads, stacked=False)
            return spec if shard_batch else sh.P(None, *spec[1:])
        spec = [None] * leaf.ndim
        if shard_batch:
            spec[0] = sh.dp_axes(mesh)
        return sh.P(*spec)

    return tree_map(spec_of, state, with_path=True)


def make_serve_step(cfg: ModelConfig, mesh, state_like, params_like,
                    global_batch: Optional[int] = None, donate: bool = True):
    """The single-token decode sharded over ``mesh``: ``step(params,
    token, index, state) -> (logits, state)``, what ``decode_step``
    computes on the global batch.  ``params`` and ``state``: DTensors or
    whole tensors (distributed on entry); ``token`` [B]; ``index`` the
    cache occupancy.  The logits come out as a DTensor [B, V_padded]
    with the batch over the data-parallel axes (replicated when
    ``global_batch`` does not divide over them; the reference's ``P(dp,
    None)``), the state as DTensors under ``decode_state_specs``.  A MoE
    layer routes the tokens of every rank as one batch, each rank of
    ``model`` running its own experts.  ``donate`` is accepted and
    ignored; as ``decode_step`` does, the step writes the caches of its
    state in place (this rank's blocks)."""
    from ..launch.collectives import gather_cols
    from ..launch.mesh import mesh_device
    from ..models import moe as moe_mod
    from ..models import transformer as tr
    dp = sh.dp_axes(mesh)
    n_dp = sh.axes_size(mesh, dp)
    shard_batch = global_batch is None or global_batch % n_dp == 0
    bdp = dp if shard_batch else None
    tr.set_activation_spec(sh.NamedSharding(mesh, sh.P(bdp, None, None)))
    moe_mod.set_ep_spec(sh.NamedSharding(mesh, sh.P("model", None, None)))
    pspecs = sh.param_specs(params_like, mode="serve")
    sh.param_shardings(mesh, params_like, "serve")     # every dim divides
    sspecs = decode_state_specs(cfg, mesh, state_like, shard_batch)
    group = sh.axes_group(mesh, dp) if shard_batch else None
    moe_group = group if cfg.moe is not None and shard_batch and \
        n_dp > 1 else None
    tp = sh.TPContext(mesh, "serve")
    tok_pl = sh.placements(mesh, sh.P(bdp))
    logit_pl = sh.placements(mesh, sh.P(bdp, None))
    dev = mesh_device(mesh)

    def put(t, spec):
        return t if isinstance(t, DTensor) else \
            sh.distribute(t.to(dev), mesh, spec)

    def like(t, d):
        return DTensor.from_local(t, mesh, d.placements, run_check=False,
                                  shape=d.shape, stride=d.stride())

    def step(params, token, index, state):
        local = tree_map(lambda t, s: sh.local(put(t, s)), params, pspecs)
        st = tree_map(put, state, sspecs)
        tok = put(token, sh.P(bdp)).redistribute(mesh, tok_pl).to_local()
        lg, new = decode_step(local, cfg, tok, index,
                              tree_map(sh.local, st), moe_group=moe_group,
                              tp=tp)
        lg = gather_cols(lg, tp.group)
        logits = DTensor.from_local(
            lg, mesh, logit_pl, run_check=False,
            shape=torch.Size((token.shape[0], lg.shape[1])),
            stride=(lg.shape[1], 1))
        return logits, tree_map(like, new, st)

    return step


def _copy_state(state: List[Dict[str, torch.Tensor]]
                ) -> List[Dict[str, torch.Tensor]]:
    return [{k: v.clone() for k, v in layer.items()} for layer in state]


class ServeEngine:
    """Small batched generation engine on one device (``device`` defaults
    to ``"cuda"``; with no GPU present that raises — pass
    ``device="cpu"``).  ``params`` lie on that device, dense or quantized
    (``serve.quantize``).  ``mesh`` is accepted and ignored, as the
    reference's is: the engine serves locally, with no activation
    constraint."""

    def __init__(self, cfg: ModelConfig, params, max_seq: int = 128,
                 mesh=None, device=None):
        from ..models import transformer as tr
        tr.set_activation_spec(None)   # local single-host serving
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
