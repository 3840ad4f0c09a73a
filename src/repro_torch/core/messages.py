"""ECI signalled transitions as messages (paper Table 1) + EWF v2 packing.

A copy of ``repro.core.messages``'s ``MsgType`` and of its EWF v2 layout,
with ``pack``/``unpack`` on int64 tensors (PyTorch has no general
uint64 arithmetic).  A word holds the same 64 bits as the reference's
uint64 word: ``word.numpy().view(np.uint64)`` is the reference encoding.

Layout v2 (little-endian bit offsets within the 64-bit word):

    [ 0: 4)  msg type            (MsgType, 4 bits)
    [ 4: 8)  virtual channel id  (4 bits)
    [ 8: 9)  has_payload flag
    [ 9:10)  dirty flag          (payload carries dirty data)
    [10:16)  requester node id   (6 bits — up to 64 caching remotes)
    [16:48)  line / block id     (32 bits)
    [48:64)  transaction id      (16 bits; bit 63 is the int64 sign bit)

The retired v1 layout (``pack_v1``) is not ported yet.
"""
from __future__ import annotations

import enum
from typing import NamedTuple

import torch


class MsgType(enum.IntEnum):
    """All signalled transitions of Table 1 (plus responses and NOP)."""

    NOP = 0
    # -- remote-initiated upgrades (request, no payload; response w/ payload) --
    REQ_READ_SHARED = 1     # transition 1: *I -> *S
    REQ_READ_EXCL = 2       # transition 2: *I -> IE
    REQ_UPGRADE = 3         # transition 3: *S -> IE (no payload either way)
    # -- remote-initiated (voluntary) downgrades: payload iff dirty, no reply --
    VOL_DOWNGRADE_S = 4     # transition 7 (M/E -> S)
    VOL_DOWNGRADE_I = 5     # transitions 4,5,6 (M/E/S -> I)
    # -- home-initiated downgrades: no payload; reply mandatory --
    HOME_DOWNGRADE_S = 6    # transition 9: remote must drop to S
    HOME_DOWNGRADE_I = 7    # transition 8: remote must drop to I
    # -- responses --
    RESP_DATA = 8           # carries a clean line
    RESP_DATA_DIRTY = 9     # carries a dirty line (writeback / forward)
    RESP_ACK = 10           # no payload (e.g. upgrade grant, clean invalidate)
    RESP_NACK = 11          # retry (races; kept rare by VC ordering)
    # -- non-coherent traffic multiplexed on the same link (paper §4.1) --
    IO_READ = 12
    IO_WRITE = 13
    BARRIER = 14
    IPI = 15


class Message(NamedTuple):
    """Unpacked message record (tensors of field values)."""

    msg_type: torch.Tensor
    vc: torch.Tensor
    has_payload: torch.Tensor
    dirty: torch.Tensor
    node: torch.Tensor
    line: torch.Tensor
    txn: torch.Tensor


EWF_VERSION = 2

_TYPE_SHIFT, _TYPE_BITS = 0, 4
_VC_SHIFT, _VC_BITS = 4, 4
_PAYLOAD_SHIFT = 8
_DIRTY_SHIFT = 9
_NODE_SHIFT, _NODE_BITS = 10, 6
_LINE_SHIFT, _LINE_BITS = 16, 32
_TXN_SHIFT, _TXN_BITS = 48, 16

#: Maximum node id a v2 word can carry (the engine's remote-count ceiling).
MAX_NODE = (1 << _NODE_BITS) - 1


def _i64(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.int64)


def pack(msg_type, vc, has_payload, dirty, node, line, txn) -> torch.Tensor:
    """Pack message fields into int64 words (EWF v2: 6-bit node ids).

    Fields are tensors or scalars; the result carries the reference's
    uint64 bits in two's complement (a txn id >= 2**15 sets bit 63)."""
    dev = next((a.device for a in (msg_type, vc, has_payload, dirty, node,
                                   line, txn)
                if isinstance(a, torch.Tensor)), None)
    w = _i64(msg_type, dev) << _TYPE_SHIFT
    w = w | (_i64(vc, dev) << _VC_SHIFT)
    w = w | (_i64(has_payload, dev) << _PAYLOAD_SHIFT)
    w = w | (_i64(dirty, dev) << _DIRTY_SHIFT)
    w = w | (_i64(node, dev) << _NODE_SHIFT)
    w = w | (_i64(line, dev) << _LINE_SHIFT)
    w = w | (_i64(txn, dev) << _TXN_SHIFT)
    return w


def unpack(word) -> Message:
    """Unpack v2 int64 word(s) into a Message of field tensors."""
    w = _i64(word)

    def _field(shift, bits):
        # the arithmetic right shift sign-extends bit 63; the mask drops it.
        return (w >> shift) & ((1 << bits) - 1)

    return Message(
        msg_type=_field(_TYPE_SHIFT, _TYPE_BITS).to(torch.int32),
        vc=_field(_VC_SHIFT, _VC_BITS).to(torch.int32),
        has_payload=_field(_PAYLOAD_SHIFT, 1).to(torch.bool),
        dirty=_field(_DIRTY_SHIFT, 1).to(torch.bool),
        node=_field(_NODE_SHIFT, _NODE_BITS).to(torch.int32),
        line=_field(_LINE_SHIFT, _LINE_BITS),
        txn=_field(_TXN_SHIFT, _TXN_BITS).to(torch.int32),
    )
