"""Shared pieces of the engines: the delivered-message counter fold.

The port of ``repro.core.engine._count``; the two-node ``Engine`` itself
is not ported yet.
"""
from __future__ import annotations

from ..kernels import coherency_step as K


def _count(msg_count, payload_msgs, mask, msg, has_payload):
    """Accumulate delivered-message counts by type through the
    ``count_fold`` kernel (its plain version on the CPU).  Returns the
    new ``(msg_count [16] int32, payload_msgs [] int32)``."""
    delta, pay = K.count_fold(mask.contiguous(), msg.contiguous(),
                              has_payload.contiguous())
    return msg_count + delta, payload_msgs + pay
