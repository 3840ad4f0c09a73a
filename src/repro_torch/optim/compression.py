"""int8 error-feedback gradient compression.

The port of ``repro.optim.compression``: each gradient is corrected by
the residual carried from the last step, quantized to int8 with one
symmetric per-tensor scale, and the new residual is what the
quantization lost (SGD-EF, Karimireddy et al. 2019).
``compressed_psum`` is the all-reduce over a mesh axis: the int8 payload
and the scales cross the wire.  The scale divides by a scalar on the
tensor's device (a CUDA division by a host scalar multiplies by its
reciprocal, one bit off the reference).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..tree import pick, tree_map


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, fp32 scale): ``scale = max(max |x| / 127, 1e-12)``,
    codes ``clip(round(x / scale), -127, 127)`` (half to even)."""
    xf = x.float()
    scale = torch.amax(torch.abs(xf)) / torch.tensor(
        127.0, device=xf.device)
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads, err):
    """Error feedback, then quantization: (codes tree, scale tree, new
    residual tree)."""
    def one(g, e):
        corrected = g.float() + e
        q, s = quantize(corrected)
        return q, s, corrected - dequantize(q, s)

    out = tree_map(one, grads, err)
    return pick(out, 0), pick(out, 1), pick(out, 2)


def compressed_psum(grads, err, axis: str, mesh):
    """Error-feedback int8 all-reduce of this rank's ``grads`` over the
    mesh axis ``axis`` (``mesh`` a ``DeviceMesh``, or the axis's process
    group itself): (the mean of every rank's dequantized gradients in
    fp32, this rank's new residual).  The int8 codes and the scales are
    all-gathered, and every rank sums the dequantized terms in rank
    order, as the reference's ``shard_map`` body does."""
    from ..launch.collectives import gather_stack, group_size
    group = mesh.get_group(axis) if hasattr(mesh, "get_group") else mesh
    n = group_size(group)
    q, s, new_err = compress_tree(grads, err)

    def reduce_one(qq, ss):
        all_q = gather_stack(qq, group)                 # [n, ...] int8
        all_s = gather_stack(ss, group)                 # [n]
        deq = all_q.float() * all_s.reshape((-1,) + (1,) * qq.dim())
        return deq.sum(dim=0) / torch.tensor(float(n), device=deq.device)

    return tree_map(reduce_one, q, s), new_err


def init_error(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compression_ratio(params, bits: int = 8) -> float:
    """Wire bytes of an fp32 all-reduce over the compressed one's (the
    scales amortize to ~0)."""
    return 32.0 / bits
