"""ECI signalled transitions as messages (paper Table 1) + EWF packing.

A copy of ``repro.core.messages``'s ``MsgType`` and of its EWF layouts,
with ``pack``/``unpack`` on int64 tensors (PyTorch has no general
uint64 arithmetic).  A word holds the same 64 bits as the reference's
uint64 word: ``word.numpy().view(np.uint64)`` is the reference encoding,
and ``unpack`` also takes that uint64 value as a Python int.

Layout v2 (little-endian bit offsets within the 64-bit word):

    [ 0: 4)  msg type            (MsgType, 4 bits)
    [ 4: 8)  virtual channel id  (4 bits)
    [ 8: 9)  has_payload flag
    [ 9:10)  dirty flag          (payload carries dirty data)
    [10:16)  requester node id   (6 bits — up to 64 caching remotes)
    [16:48)  line / block id     (32 bits)
    [48:64)  transaction id      (16 bits; bit 63 is the int64 sign bit)

The retired v1 layout carried a 2-bit node id, the line id at [12:44)
and a 20-bit txn id at [44:64); ``pack_v1``/``unpack_v1`` keep archived
v1 traces decodable (``core.tracing.TraceBuffer(ewf_version=1)``).
"""
from __future__ import annotations

import enum
from typing import NamedTuple

import numpy as np
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

# -- the retired v1 (2-bit-node) layout, kept for archived traces ----------
_V1_NODE_SHIFT, _V1_NODE_BITS = 10, 2
_V1_LINE_SHIFT, _V1_LINE_BITS = 12, 32
_V1_TXN_SHIFT, _V1_TXN_BITS = 44, 20

_U64 = (1 << 64) - 1


def _i64(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.int64)


def word_tensor(words) -> torch.Tensor:
    """int64 tensor of EWF words given as Python ints (their uint64
    values, as the reference's ``TraceBuffer`` holds them) or as a
    tensor, which is returned as it is."""
    if isinstance(words, torch.Tensor):
        return words.to(torch.int64)
    vals = [int(w) & _U64 for w in np.asarray(words, dtype=object).ravel()]
    signed = [w - (1 << 64) if w >> 63 else w for w in vals]
    return torch.tensor(signed, dtype=torch.int64).reshape(np.shape(words))


def word_value(word) -> int:
    """The uint64 value of one word (an int64 tensor element or an int)."""
    return int(word) & _U64


def _pack(fields, node_shift: int, line_shift: int, txn_shift: int
          ) -> torch.Tensor:
    shifts = (_TYPE_SHIFT, _VC_SHIFT, _PAYLOAD_SHIFT, _DIRTY_SHIFT,
              node_shift, line_shift, txn_shift)
    dev = next((a.device for a in fields if isinstance(a, torch.Tensor)),
               None)
    w = _i64(fields[0], dev) << shifts[0]
    for f, sh in zip(fields[1:], shifts[1:]):
        w = w | (_i64(f, dev) << sh)
    return w


def _unpack(word, node_shift, node_bits, line_shift, line_bits, txn_shift,
            txn_bits) -> Message:
    w = word_tensor(word)

    def _field(shift, bits):
        # the arithmetic right shift sign-extends bit 63; the mask drops it.
        return (w >> shift) & ((1 << bits) - 1)

    return Message(
        msg_type=_field(_TYPE_SHIFT, _TYPE_BITS).to(torch.int32),
        vc=_field(_VC_SHIFT, _VC_BITS).to(torch.int32),
        has_payload=_field(_PAYLOAD_SHIFT, 1).to(torch.bool),
        dirty=_field(_DIRTY_SHIFT, 1).to(torch.bool),
        node=_field(node_shift, node_bits).to(torch.int32),
        line=_field(line_shift, line_bits),
        txn=_field(txn_shift, txn_bits).to(torch.int32),
    )


def pack(msg_type, vc, has_payload, dirty, node, line, txn):
    """Pack message fields into int64 words (EWF v2: 6-bit node ids).

    Fields are tensors or scalars; the result carries the reference's
    uint64 bits in two's complement (a txn id >= 2**15 sets bit 63)."""
    return _pack((msg_type, vc, has_payload, dirty, node, line, txn),
                 _NODE_SHIFT, _LINE_SHIFT, _TXN_SHIFT)


def unpack(word) -> Message:
    """Unpack v2 word(s) (int64 tensors, or uint64 values as Python ints)
    into a Message of field tensors."""
    return _unpack(word, _NODE_SHIFT, _NODE_BITS, _LINE_SHIFT, _LINE_BITS,
                   _TXN_SHIFT, _TXN_BITS)


def pack_v1(msg_type, vc, has_payload, dirty, node, line, txn):
    """Pack in the retired 2-bit-node v1 layout (archived-trace format)."""
    return _pack((msg_type, vc, has_payload, dirty, node, line, txn),
                 _V1_NODE_SHIFT, _V1_LINE_SHIFT, _V1_TXN_SHIFT)


def unpack_v1(word) -> Message:
    """Decode v1 word(s), as ``unpack`` takes them, as the original
    decoder did."""
    return _unpack(word, _V1_NODE_SHIFT, _V1_NODE_BITS, _V1_LINE_SHIFT,
                   _V1_LINE_BITS, _V1_TXN_SHIFT, _V1_TXN_BITS)


def to_json(msg: Message) -> dict:
    """JSON-serializable form (the paper's JSON trace format analogue)."""
    return {
        "type": MsgType(int(msg.msg_type)).name,
        "vc": int(msg.vc),
        "has_payload": bool(msg.has_payload),
        "dirty": bool(msg.dirty),
        "node": int(msg.node),
        "line": int(msg.line),
        "txn": int(msg.txn),
    }
