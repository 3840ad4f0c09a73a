"""Virtual-channel transport layer (paper §4.2) on tensors.

The port of ``repro.core.transport``: each line has at most one message
in flight per direction and initiator; a message is (msg, dirty, payload,
age) and is DELIVERED when its age reaches its VC's delay (distinct
per-VC delays reorder delivery across VCs, as the real link does);
per-VC credits bound the messages in flight, and a submission without
credit stalls (the caller retries), it is never dropped.

Every operation is polymorphic over LEADING batch axes: ``[L]`` fields
model one initiator, ``[R, L]`` the N-remote engine's R initiators over
one slab.  Credits are accounted PER INITIATOR row — the per-row credit
rank is the ``credit_rank`` kernel; the ``shared=True`` pool across rows
stays plain tensor code, as it is plain ``jnp`` in the reference.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..kernels import coherency_step as K
from .messages import MsgType

# Message classes, each mapped to its own VC pair (odd/even lines).
CLASS_REMOTE_REQ = 0    # remote -> home coherence requests
CLASS_HOME_RESP = 1     # home -> remote responses
CLASS_HOME_REQ = 2      # home -> remote (home-initiated downgrades)
CLASS_REMOTE_RESP = 3   # remote -> home responses to home requests
CLASS_IO = 4            # non-coherent IO/barrier/IPI traffic
N_CLASSES = 5

#: 10 coherence VCs (5 classes x odd/even) as in the reference design.
N_VCS = 2 * N_CLASSES

#: Per-VC delivery delay in engine steps (cross-VC reordering).
DEFAULT_DELAYS = np.asarray([1, 2, 1, 3, 2, 1, 3, 1, 2, 2], np.int32)

#: Per-VC credits (max messages in flight).
DEFAULT_CREDITS = np.asarray([64] * N_VCS, np.int32)

_NOP = int(MsgType.NOP)


def vc_of(line, msg_class):
    """VC id for a (line, class): odd/even interleaving within the class."""
    return msg_class * 2 + (line & 1)


@functools.lru_cache(maxsize=None)
def vc_index(n_lines: int, msg_class: int, device: str) -> torch.Tensor:
    """``[L]`` int64 VC id of every line for ``msg_class`` (built once per
    shape and device; the step gathers per-VC delays/credits with it)."""
    return vc_of(torch.arange(n_lines, device=device), msg_class)


class Channel(NamedTuple):
    """One direction of per-line in-flight messages (struct-of-arrays)."""

    msg: torch.Tensor       # [..., L] int8, MsgType (NOP = empty slot)
    dirty: torch.Tensor     # [..., L] bool
    payload: torch.Tensor   # [..., L, B] line data
    age: torch.Tensor       # [..., L] int32


def make_channel(n_lines: int, block: int, dtype=torch.float32,
                 device="cpu", lead: Tuple[int, ...] = ()) -> Channel:
    return Channel(
        msg=torch.zeros(lead + (n_lines,), dtype=torch.int8, device=device),
        dirty=torch.zeros(lead + (n_lines,), dtype=torch.bool, device=device),
        payload=torch.zeros(lead + (n_lines, block), dtype=dtype,
                            device=device),
        age=torch.zeros(lead + (n_lines,), dtype=torch.int32, device=device),
    )


def occupancy(ch: Channel, msg_class: int) -> torch.Tensor:
    """Per-VC occupancy ``[..., N_VCS]`` of a channel carrying
    ``msg_class`` — one row per leading-axis initiator."""
    vcs = vc_index(ch.msg.shape[-1], msg_class, str(ch.msg.device))
    active = (ch.msg != _NOP).to(torch.int32)
    out = torch.zeros(ch.msg.shape[:-1] + (N_VCS,), dtype=torch.int32,
                      device=ch.msg.device)
    return out.index_add_(-1, vcs, active)


def credit_accept(ch: Channel, msg_class: int, cand: torch.Tensor,
                  credits: torch.Tensor, *,
                  shared: bool = False) -> torch.Tensor:
    """[..., L] mask of candidates within their VC's credit.

    A candidate is in credit iff its VC's occupancy plus the number of
    earlier candidates on the same VC (stable line order within each
    initiator row) stays below the credit.  ``shared=True`` ranks over
    the last two axes instead — one budget for the whole ``[R, L]``
    slab (row-major order)."""
    L = ch.msg.shape[-1]
    vcs = vc_index(L, msg_class, str(ch.msg.device))
    active = ch.msg != _NOP
    if shared and ch.msg.dim() > 1:
        odd = (vcs & 1).bool()
        c_o = (cand & odd).to(torch.int32)
        c_e = (cand & ~odd).to(torch.int32)
        occ_o = (active & odd).sum((-2, -1), keepdim=True, dtype=torch.int32)
        occ_e = (active & ~odd).sum((-2, -1), keepdim=True,
                                    dtype=torch.int32)
        flat_o = c_o.reshape(c_o.shape[:-2] + (-1,))
        flat_e = c_e.reshape(c_e.shape[:-2] + (-1,))
        rank_o = (torch.cumsum(flat_o, -1, dtype=torch.int32)
                  - flat_o).reshape(cand.shape)
        rank_e = (torch.cumsum(flat_e, -1, dtype=torch.int32)
                  - flat_e).reshape(cand.shape)
        occ_rank = torch.where(odd, occ_o + rank_o, occ_e + rank_e)
    else:
        occ_rank = K.credit_rank(active, cand.contiguous())
    return cand & (occ_rank < credits[vcs])


def place(ch: Channel, accept: torch.Tensor, msg: torch.Tensor,
          dirty: torch.Tensor, payload: torch.Tensor) -> Channel:
    """Write messages into slots for an acceptance mask ALREADY decided
    (the request path's single-ranking fast path)."""
    return Channel(
        msg=torch.where(accept, msg, ch.msg),
        dirty=torch.where(accept, dirty, ch.dirty),
        payload=torch.where(accept[..., None], payload, ch.payload),
        age=ch.age.masked_fill(accept, 0),
    )


def submit(ch: Channel, msg_class: int, want: torch.Tensor,
           msg: torch.Tensor, dirty: torch.Tensor, payload: torch.Tensor,
           credits: torch.Tensor, *, unbounded: bool = False,
           shared: bool = False) -> Tuple[Channel, torch.Tensor]:
    """Try to enqueue messages for lines where ``want`` is set.

    Returns the updated channel and the ACCEPTED mask.  A submit is
    refused when the slot is busy or the VC is out of credit;
    ``unbounded=True`` skips the credit ranking (responses always sink)."""
    cand = want & (ch.msg == _NOP)
    accept = cand if unbounded else credit_accept(ch, msg_class, cand,
                                                  credits, shared=shared)
    return place(ch, accept, msg, dirty, payload), accept


def tick(ch: Channel) -> Channel:
    """Advance time for all in-flight messages."""
    return ch._replace(age=ch.age + (ch.msg != _NOP))


def any_in_flight(ch: Channel) -> torch.Tensor:
    """[..., L] bool — any message in flight per line across the remote
    axis."""
    return (ch.msg != _NOP).any(dim=-2)


def deliver(ch: Channel, msg_class: int, delays: torch.Tensor,
            delay_l: torch.Tensor = None) -> Tuple[Channel, torch.Tensor]:
    """Pop messages whose age has reached their VC's delay.

    Returns (channel with delivered slots freed, delivered mask); the
    message fields of delivered lines are read from the INPUT channel.
    ``delay_l`` optionally supplies the hoisted per-line delays."""
    if delay_l is None:
        delay_l = delays[vc_index(ch.msg.shape[-1], msg_class,
                                  str(ch.msg.device))]
    ready = (ch.msg != _NOP) & (ch.age >= delay_l)
    return ch._replace(msg=ch.msg.masked_fill(ready, _NOP)), ready
