"""Plain PyTorch versions of the port's kernels.

Each function mirrors its twin in ``repro.kernels.ref`` on tensors: the
six coherency-step kernels (the engine's own expressions there) and the
three near-memory operators (``select_scan_ref``, ``regex_dfa_ref``,
``hash_probe_ref``) and the model substrate's two (``flash_attention_ref``
with its chunked schedule ``chunked_attention``, and ``rglru_scan_ref``).
The wrappers in ``kernels.coherency_step``, ``kernels.nmp`` and
``kernels.models`` run these for tensors on the CPU — the path the tests
hold against ``repro`` — and ``chip_smoke.py`` compares every CUDA kernel
with its plain version on the card.  The first nine are integer
arithmetic or copies of bits, so their contract is bit-exact equality;
the two float ones are held allclose, at 2e-5 (attention) and 3e-5
(RG-LRU) in fp32, 2e-2 and 3e-2 in bf16.

Packed directory words are int32 tensors holding the reference's uint32
bits (bit 31 is the sign bit): torch has no ``>>`` or ``~`` for uint32
on the CPU and no popcount, and every packed operation is a bitwise
AND/OR/NOT or a compare with zero, which the sign does not change.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..nmp.kvstore import walk_chains
from ..nmp.select import scalar


#: ``_BITS[s]`` is the int32 word with bit ``s`` set; ``1 << 31`` is written
#: as its two's-complement value, where a shift would overflow.
_BITS = [1 << s for s in range(31)] + [-(1 << 31)]


@functools.lru_cache(maxsize=None)
def bit_table(device: str) -> torch.Tensor:
    """[32] int32: the one-bit words, indexed by bit position (built once
    per device: a host-to-card copy inside the step loop would make the
    host wait)."""
    return torch.tensor(_BITS, dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def arange_cached(n: int, device: str, dtype=torch.int64) -> torch.Tensor:
    """``torch.arange(n)`` on ``device``, built once (read-only)."""
    return torch.arange(n, dtype=dtype, device=device)


def node_hot(node: torch.Tensor, W: int) -> torch.Tensor:
    """``[..., L, W]`` int32 one-hot word mask of per-line remote id
    ``node`` (``[..., L]``, non-negative)."""
    node = node.long()
    dev = str(node.device)
    sel = arange_cached(W, dev) == (node // 32)[..., None]
    return torch.where(sel, bit_table(dev)[node % 32][..., None], 0)


def _parity_odd(L: int, device) -> torch.Tensor:
    return (torch.arange(L, device=device) & 1).bool()


def credit_rank_ref(active: torch.Tensor, cand: torch.Tensor
                    ) -> torch.Tensor:
    """[..., L] int32 parity-split credit rank (``transport.credit_accept``).

    For each leading-axis initiator row: a candidate's rank against its
    odd/even VC is the VC's current occupancy plus the number of EARLIER
    candidates (stable line order) on the same parity."""
    L = active.shape[-1]
    odd = _parity_odd(L, active.device)
    c_o = (cand & odd).to(torch.int32)
    c_e = (cand & ~odd).to(torch.int32)
    occ_o = (active & odd).sum(-1, keepdim=True, dtype=torch.int32)
    occ_e = (active & ~odd).sum(-1, keepdim=True, dtype=torch.int32)
    rank_o = torch.cumsum(c_o, dim=-1, dtype=torch.int32) - c_o
    rank_e = torch.cumsum(c_e, dim=-1, dtype=torch.int32) - c_e
    return torch.where(odd, occ_o + rank_o, occ_e + rank_e)


def arb_winner_ref(ready_all: torch.Tensor, arb_rr: torch.Tensor
                   ) -> torch.Tensor:
    """[..., L] int32 rotating-priority winner select (``step_mn`` phase 4).

    Participant p's priority on a line is ``(p - arb_rr) mod P`` (floor
    modulo, as ``jnp``'s ``%``; torch's ``%`` on integers is a floor
    modulo too); the winner is the ready participant of minimum priority,
    ties — only at the not-ready fill value P — going to the LOWEST id."""
    P = ready_all.shape[-2]
    p = torch.arange(P, device=ready_all.device, dtype=torch.int32)
    prio = (p[:, None] - arb_rr.to(torch.int32)[..., None, :]) % P
    score = torch.where(ready_all, prio, torch.full_like(prio, P))
    return torch.argmin(score, dim=-2).to(torch.int32)


def count_fold_ref(mask: torch.Tensor, msg: torch.Tensor,
                   has_payload: torch.Tensor,
                   base: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   grouped: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Delivered-message fold (``engine._count``): a 16-bin histogram of
    ``msg`` under ``mask`` over ALL axes, plus the count of masked lanes
    carrying a payload.  Returns (delta [16] int32, payload delta []
    int32), or with ``base=(msg_count [16], payload_msgs [])`` int32 the
    running totals ``base + delta``; codes outside 0..15 land in no
    bin.  ``grouped=True`` folds each slice of the leading axis (G) into
    its own row: ([G, 16], [G]), onto a base of those shapes."""
    G = mask.shape[0] if grouped else 1
    types = torch.arange(16, device=msg.device, dtype=torch.int32)
    eq = msg.to(torch.int32)[..., None] == types
    hist = (eq & mask[..., None]).reshape(G, -1, 16).sum(1,
                                                         dtype=torch.int32)
    pay = (mask & has_payload).reshape(G, -1).sum(1, dtype=torch.int32)
    if not grouped:
        hist, pay = hist[0], pay[0]
    if base is None:
        return hist, pay
    return base[0] + hist, base[1] + pay


def lat_hist_ref(lat: torch.Tensor, retired: torch.Tensor,
                 edges: Tuple[int, ...]) -> torch.Tensor:
    """[R, NB] int32 retirement-latency histogram delta
    (``traffic.counters.update_counters``): bucket ``searchsorted(edges,
    lat, side="right")``, i.e. ``sum_e (lat >= e)``; only ``retired``
    lanes count, and a negative latency lands in bucket 0."""
    e = torch.as_tensor(edges, dtype=torch.int32, device=lat.device)
    nb = len(edges) + 1
    bucket = torch.bucketize(lat.to(torch.int32), e, right=True)
    onehot = bucket[..., None] == torch.arange(nb, device=lat.device)
    return (onehot & retired[..., None]).sum(1, dtype=torch.int32)


def packed_any_ref(*planes: torch.Tensor) -> torch.Tensor:
    """[..., L] bool — any bit set per line of a packed ``[..., L, W]``
    int32 plane (``directory_mn.any_bits``: the packed ``no_sharers`` and
    pending-home-downgrade reductions), or of the OR of several planes of
    one shape."""
    words = planes[0]
    for p in planes[1:]:
        words = words | p
    return (words != 0).any(dim=-1)


def packed_fanout_ref(pres: torch.Tensor, excl: torch.Tensor,
                      node: torch.Tensor, shared_req: torch.Tensor,
                      excl_req: torch.Tensor,
                      home_read: Optional[torch.Tensor] = None,
                      home_write: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed fan-out target sets (``directory_mn.needed_words``).

    ``pres``/``excl`` are the ``[..., L, W]`` presence/exclusive word
    planes, ``node`` the per-line requester id, ``shared_req`` /
    ``excl_req`` the per-line request-kind masks.  Returns ``(recall_w,
    inval_w)``: recall (HOME_DOWNGRADE_S) goes to the EM holders other
    than the requester on a shared read, invalidate (HOME_DOWNGRADE_I)
    to every non-I holder other than the requester on an exclusive or
    upgrade request.  With the per-line ``home_read``/``home_write``, a
    line where either is set takes the home side's sets instead
    (the reference's ``directory_mn.home_needed_words``): invalidate every holder for a
    write, recall the EM holders not invalidated for a read."""
    hot = node_hot(node, pres.shape[-1])
    recall_w = torch.where(shared_req[..., None], excl & ~hot, 0)
    inval_w = torch.where(excl_req[..., None], pres & ~hot, 0)
    if home_read is None:
        return recall_w, inval_w
    inval_h = torch.where(home_write[..., None], pres, 0)
    recall_h = torch.where(home_read[..., None], excl, 0) & ~inval_h
    home = (home_read | home_write)[..., None]
    return (torch.where(home, recall_h, recall_w),
            torch.where(home, inval_h, inval_w))


def select_scan_ref(table: torch.Tensor, x, y, block_rows: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise SELECT: in each block of ``block_rows`` rows the rows
    with ``col0 > x & col1 < y`` (``x``, ``y`` cast to the table's dtype)
    are packed to the front in row order, zeros after.  Returns (packed
    [n_blocks, block_rows, w], counts [n_blocks] int32)."""
    x, y = scalar(x, table.dtype), scalar(y, table.dtype)
    n, w = table.shape
    if n % block_rows:
        raise ValueError(f"select_scan: {n} rows are not a multiple of "
                         f"block_rows={block_rows}")
    blocks = table.reshape(n // block_rows, block_rows, w)
    mask = (blocks[..., 0] > x) & (blocks[..., 1] < y)
    counts = mask.sum(dim=1, dtype=torch.int32)
    order = torch.argsort((~mask).to(torch.int8), dim=1, stable=True)
    packed = torch.gather(blocks, 1, order[..., None].expand(-1, -1, w))
    keep = torch.arange(block_rows, device=table.device) < counts[:, None]
    return torch.where(keep[..., None], packed, 0), counts


def regex_dfa_ref(trans: torch.Tensor, accept: torch.Tensor,
                  strings: torch.Tensor) -> torch.Tensor:
    """[rows] bool: ``accept`` of the state each NUL-padded row of
    ``strings`` ([rows, width] uint8) ends in, walking ``trans``
    ([n_states, 256] int32) from state 0 (accept states absorb, so that
    is whether the row matches)."""
    state = torch.zeros(strings.shape[0], dtype=torch.int64,
                        device=strings.device)
    flat = trans.reshape(-1)
    chars = strings.to(torch.int64)
    for pos in range(strings.shape[1]):
        state = flat[state * 256 + chars[:, pos]].to(torch.int64)
    return accept[state]


#: (found_idx [q] int32, -1 on a miss; steps [q] int32) of a chained
#: probe: the bucket of each query's ``fib_hash`` and at most
#: ``max_chain`` entries of its chain (``nmp.kvstore.walk_chains``).
hash_probe_ref = walk_chains


#: a masked attention logit (the reference's ``-1e30``).
NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        kv_length=None) -> torch.Tensor:
    """Dense-softmax attention (``repro.kernels.ref.flash_attention_ref``).

    q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D] with Hq % Hkv == 0 (query
    head h reads KV head h // (Hq / Hkv)).  ``window``: key j is visible
    from query i iff i - j < window; ``softcap``: ``cap * tanh(x / cap)``;
    ``kv_length`` (an int or a 0-d tensor): the valid KV positions, with
    the queries at the END of the valid region.  Scale ``D ** -0.5``.
    Returns v's dtype."""
    B, Hq, Sq, D = q.shape
    rep = Hq // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * \
        D ** -0.5
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    Skv = k.shape[2]
    valid = Skv if kv_length is None else kv_length
    qi = torch.arange(Sq, device=q.device)[:, None] + (valid - Sq)
    kj = torch.arange(Skv, device=q.device)[None, :]
    mask = kj < valid
    if causal:
        mask = mask & (kj <= qi)
    if window is not None:
        mask = mask & ((qi - kj) < window)
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(v.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, window: Optional[int] = None,
                      softcap: Optional[float] = None, kv_length=None,
                      chunk_q: int = 512, chunk_k: int = 1024
                      ) -> torch.Tensor:
    """Flash-style double-chunked attention
    (``repro.kernels.ref.chunked_attention``): one (chunk_q x chunk_k)
    logit tile per (batch, head) at a time, an online softmax over the key
    chunks, GQA folded into the queries so KV is never repeated.  Ragged
    shapes fall through to ``flash_attention_ref``.  Returns q's dtype.

    Under autograd each query block is recomputed in the backward pass
    (the reference's ``jax.checkpoint(q_block)``), so the backward keeps
    each block's queries and no tile; without grad the blocks run
    directly, the same operations in the same order."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    cq, ck = min(chunk_q, Sq), min(chunk_k, Sk)
    if Sq % cq or Sk % ck:
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, kv_length=kv_length)
    scale = D ** -0.5
    valid = Sk if kv_length is None else kv_length
    q5 = q.reshape(B, Hkv, rep, Sq, D).float()
    kf, vf = k.float(), v.float()

    def q_block(qb, q_pos):
        m = torch.full((B, Hkv, rep, cq), NEG_INF, device=q.device)
        l = torch.zeros((B, Hkv, rep, cq), device=q.device)
        acc = torch.zeros((B, Hkv, rep, cq, D), device=q.device)
        for j in range(Sk // ck):
            kb = kf[:, :, j * ck:(j + 1) * ck]
            vb = vf[:, :, j * ck:(j + 1) * ck]
            k_pos = j * ck + torch.arange(ck, device=q.device)
            lg = torch.einsum("bhrqd,bhkd->bhrqk", qb, kb) * scale
            if softcap is not None:
                lg = softcap * torch.tanh(lg / softcap)
            mask = (k_pos < valid)[None, :]
            if causal:
                mask = mask & (k_pos[None, :] <= q_pos[:, None])
            if window is not None:
                mask = mask & ((q_pos[:, None] - k_pos[None, :]) < window)
            lg = torch.where(mask, lg, NEG_INF)
            m2 = torch.maximum(m, lg.amax(dim=-1))
            dead = m2 <= -1e29
            alpha = torch.where(dead, 1.0, torch.exp(m - m2))
            p = torch.where(dead[..., None], 0.0,
                            torch.exp(lg - m2[..., None]))
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhrqk,bhkd->bhrqd", p, vb)
            m = m2
        out = acc / torch.where(l == 0.0, 1.0, l)[..., None]
        return out.to(q.dtype)

    remat = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    outs = []
    for i in range(Sq // cq):
        qb = q5[:, :, :, i * cq:(i + 1) * cq]
        q_pos = i * cq + torch.arange(cq, device=q.device) + (valid - Sq)
        if remat:
            outs.append(checkpoint(q_block, qb, q_pos, use_reentrant=False,
                                   preserve_rng_state=False))
        else:
            outs.append(q_block(qb, q_pos))
    return torch.cat(outs, dim=3).reshape(B, Hq, Sq, D)


#: tokens a chunk of the plain RG-LRU scan (``rglru_scan_ref``).
RGLRU_CHUNK = 64


def rglru_scan_ref(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 0)) x_t`` per channel
    (``repro.kernels.ref.rglru_scan_ref``): x, a [B, S, D] -> h [B, S, D]
    in x's dtype, the carry in fp32 from zeros.

    In chunks of C = ``min(RGLRU_CHUNK, S)`` tokens, S padded to whole
    chunks with a = 1 and x = 0: the recurrence runs over a chunk's C
    positions from a zero carry, for all chunks at once, beside the
    decays ``P_t = a_1 ... a_t`` from the chunk's start (``cumprod``);
    then one ``addcmul`` a chunk carries the state across chunks,
    ``c_{n+1} = P_C c_n + h_C``, and ``h_t = h_local_t + P_t c_n``.  A
    decay is only ever a product along the chunk, never an exponential
    of summed logs nor a quotient of two products: a may be exactly 0.
    Autograd differentiates the whole scan; no loop runs over the
    tokens."""
    B, S, D = x.shape
    C = min(RGLRU_CHUNK, S)
    N = -(-S // C)
    af = a.float()
    gx = torch.sqrt(torch.clamp(1.0 - af ** 2, min=0.0)) * x.float()
    af = F.pad(af, (0, 0, 0, N * C - S), value=1.0).view(B, N, C, D)
    gx = F.pad(gx, (0, 0, 0, N * C - S)).view(B, N, C, D)
    h = gx[:, :, 0]
    local = [h]
    for at, gt in zip(af.unbind(2)[1:], gx.unbind(2)[1:]):
        h = torch.addcmul(gt, at, h)
        local.append(h)
    local = torch.stack(local, 2)                       # [B, N, C, D]
    decay = torch.cumprod(af, dim=2)
    carry = torch.zeros_like(h[:, 0])
    starts = [carry]
    for dec, end in zip(decay[:, :-1, -1].unbind(1),
                        local[:, :-1, -1].unbind(1)):
        carry = torch.addcmul(end, dec, carry)
        starts.append(carry)
    h = torch.addcmul(local, decay, torch.stack(starts, 1)[:, :, None])
    return h.reshape(B, N * C, D)[:, :S].to(x.dtype)
