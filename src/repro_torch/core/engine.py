"""Shared pieces of the engines: the delivered-message counter fold.

The port of ``repro.core.engine._count``; the two-node ``Engine`` itself
is not ported yet.
"""
from __future__ import annotations

from ..kernels import coherency_step as K


def _count(msg_count, payload_msgs, mask, msg, has_payload):
    """Accumulate delivered-message counts by type through the
    ``count_fold`` kernel (its plain version on the CPU), which adds the
    running totals in the same launch.  Returns the new ``(msg_count [16]
    int32, payload_msgs [] int32)``.

    A fleet state carries one row of counts per member, ``msg_count [M,
    16]`` and ``payload_msgs [M]``, with the member axis leading every
    plane: then each member's lanes fold into its own row, through the
    grouped form of the same one launch."""
    if msg_count.dim() == 2:
        G = msg_count.shape[0]
        return K.count_fold(mask.reshape(G, -1).contiguous(),
                            msg.reshape(G, -1).contiguous(),
                            has_payload.reshape(G, -1).contiguous(),
                            base=(msg_count, payload_msgs), grouped=True)
    return K.count_fold(mask.contiguous(), msg.contiguous(),
                        has_payload.contiguous(),
                        base=(msg_count, payload_msgs))
