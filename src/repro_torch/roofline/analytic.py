"""Analytic roofline terms from first principles.

A copy of ``repro.roofline.analytic`` over the port's ``configs`` and
``models.config``: the arithmetic is the reference's, term for term.  The
dry run (``launch/dryrun.py``) records these closed-form terms beside the
numbers it counts over one traced step, and ``analysis.analytic_roofline``
turns them into times at the H100's rates.  ``mesh_desc`` reads the axis
sizes of a ``DeviceMesh`` (a tuple ``shape`` with ``mesh_dim_names``), of
a stand-in whose ``shape`` is a dict of axis sizes, or takes a
``MeshDesc`` as it is.

All quantities are per device per step.  Conventions:

* ``tp`` = model-axis shards; ``fsdp`` = data-axis shards; ``pods`` = pod
  count; ``chips = tp * fsdp * pods``.
* Weights bf16 (2 B); optimizer moments + master math f32 (4 B).
* train FLOPs = fwd * (1 fwd + 2 bwd + 1 remat-refwd) = 4x fwd-flops
  (the classic 6ND becomes 8ND with full remat; we report both).
* Ring-collective bytes per device for payload P over n shards:
  all-gather / reduce-scatter: P * (n-1)/n ; all-reduce: 2 * P * (n-1)/n.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

from ..configs import ShapeCell
from ..models.config import ModelConfig

WB = 2       # weight bytes (bf16)
AB = 2       # activation bytes (bf16)
OB = 4       # optimizer / master bytes (f32)


@dataclasses.dataclass(frozen=True)
class MeshDesc:
    tp: int
    fsdp: int
    pods: int = 1

    @property
    def chips(self) -> int:
        return self.tp * self.fsdp * self.pods

    @property
    def dp(self) -> int:
        return self.fsdp * self.pods


def mesh_desc(mesh) -> MeshDesc:
    if isinstance(mesh, MeshDesc):
        return mesh
    sizes = mesh.shape if isinstance(mesh.shape, Mapping) else dict(
        zip(mesh.mesh_dim_names, mesh.shape))
    return MeshDesc(tp=sizes["model"], fsdp=sizes["data"],
                    pods=sizes.get("pod", 1))


def _attention_flops(cfg: ModelConfig, B: int, Sq: int, Sk: float) -> float:
    """Global QK^T + PV flops for ONE attention layer (2 matmuls x 2
    flops/MAC)."""
    return 4.0 * B * cfg.n_heads * cfg.head_dim_ * Sq * Sk


def _layer_seq(cfg: ModelConfig):
    return list(cfg.block_pattern) * cfg.n_superlayers + list(
        cfg.tail_pattern)


def analytic_terms(cfg: ModelConfig, cell: ShapeCell, md: MeshDesc, *,
                   weight_bytes: float = WB, kv_bytes_elem: float = AB
                   ) -> Dict[str, float]:
    """Returns global flops + per-device HBM and collective bytes.

    ``weight_bytes``/``kv_bytes_elem`` parameterize the §Perf variants
    (int8 weight-only serving, int8 KV cache)."""
    B, S = cell.global_batch, cell.seq_len
    N = cfg.active_param_count()            # ACTIVE params: flops only
    N_total = cfg.param_count()             # resident params: bytes/wires
    n_emb = cfg.padded_vocab * cfg.d_model * (
        1 if cfg.tie_embeddings else 2)
    n_body = N - n_emb                      # matmul params in the blocks

    if cell.kind == "decode":
        tokens, Sq = B, 1
    else:
        tokens, Sq = B * S, S

    # ---------------- FLOPs (global) ----------------
    # LM head (+ embedding is a gather): train computes the full head;
    # prefill only the last position.
    head_tokens = tokens if cell.kind == "train" else B
    fwd_core = (2.0 * tokens * n_body
                + 2.0 * head_tokens * cfg.d_model * cfg.padded_vocab)
    fwd = fwd_core
    for b in _layer_seq(cfg):
        if b == "ga":
            Sk = (S + 1) / 2 if cell.kind != "decode" else S
            fwd += _attention_flops(cfg, B, Sq, Sk)
        elif b == "la":
            w = min(cfg.window or S, S)
            Sk = w if cell.kind == "decode" else min(w, (S + 1) / 2)
            fwd += _attention_flops(cfg, B, Sq, Sk)
        elif b == "rg":
            fwd += 10.0 * tokens * cfg.d_model          # elementwise scan
        elif b == "rwkv":
            hd = cfg.rwkv_head_dim
            fwd += 4.0 * tokens * cfg.d_model * hd      # state outer-prods
    if cfg.encoder is not None and cell.kind != "decode":
        Te = cfg.encoder.n_frames
        enc_p = cfg.encoder.n_layers * (
            2 * cfg.d_model * cfg.n_heads * cfg.head_dim_
            + 2 * cfg.d_model * cfg.n_kv_heads * cfg.head_dim_
            + 2 * cfg.d_model * cfg.d_ff)
        fwd += 2.0 * B * Te * enc_p
        fwd += cfg.encoder.n_layers * _attention_flops(cfg, B, Te, Te)

    if cell.kind == "train":
        # remat re-forward: "full" recomputes everything (+1 fwd); "dots"
        # saves matmul outputs and recomputes only elementwise (+~0.15).
        refwd = {"full": 1.0, "dots": 0.15}.get(cfg.remat_policy, 1.0) \
            if cfg.remat else 0.0
        flops = fwd * (3.0 + refwd)
    else:
        flops = fwd

    # ---------------- HBM bytes (per device) ----------------
    n_layers_eff = len(_layer_seq(cfg))
    w_local = N_total * weight_bytes / md.tp  # resident weights/device
    tok_local = tokens / md.dp
    act_rw = 12.0 * tok_local * cfg.d_model * AB * n_layers_eff
    if cell.kind == "train":
        # "dots" remat saves matmul outputs: no weight re-read in backward.
        weight_passes = 3.0 + (1.0 if cfg.remat
                               and cfg.remat_policy == "full" else 0.0)
        opt = 28.0 * N_total * OB / md.chips  # p/m/v r+w + grad read, f32
        mem = w_local * weight_passes + opt + act_rw * 2.0
    elif cell.kind == "prefill":
        mem = w_local + act_rw
    else:  # decode: weights + full KV/state sweep dominate
        kv_bytes = 0.0
        for b in _layer_seq(cfg):
            if b == "ga":
                kv_bytes += (2 * B * cfg.n_kv_heads * S * cfg.head_dim_
                             * kv_bytes_elem)
            elif b == "la":
                w = min(cfg.window or S, S)
                kv_bytes += (2 * B * cfg.n_kv_heads * w * cfg.head_dim_
                             * kv_bytes_elem)
            elif b == "rwkv":
                hd = cfg.rwkv_head_dim
                kv_bytes += (cfg.d_model // hd) * hd * hd * B * 4
            elif b == "rg":
                kv_bytes += B * cfg.d_model * 4
        mem = w_local + kv_bytes / md.chips + act_rw

    # ---------------- collective bytes (per device) ----------------
    coll = 0.0
    ring = lambda payload, n: payload * (n - 1) / n
    if cell.kind == "train":
        # FSDP: all-gather weights fwd + bwd re-gather + reduce-scatter grads
        coll += 3.0 * ring(N_total * WB / md.tp, md.fsdp)
        # cross-pod DP all-reduce of grads (bf16 wire)
        if md.pods > 1:
            coll += 2.0 * ring(N_total * WB / (md.tp * md.fsdp), md.pods)
        # optimizer runs on the fsdp-sharded grads; no extra traffic.
    else:
        # weights are resident (no FSDP gather on the serving path)
        pass
    # TP activation all-reduces: ~2 psums per layer over tokens x d.
    tp_payload = tok_local * cfg.d_model * AB
    coll += 2.0 * n_layers_eff * 2.0 * ring(tp_payload, md.tp)
    if cfg.moe is not None and cell.kind != "decode":
        # dispatch+combine buffers cross the EP axis once per MoE layer
        # per direction; train adds the two backward crossings.
        # dispatch_int8 (§Perf) compresses the FORWARD crossings to 1 B/elem
        # (+1 scale/slot, amortized ~0); the backward cotangent stays bf16.
        buf_elems = tokens * cfg.moe.top_k * cfg.moe.capacity_factor \
            * cfg.d_model
        fwd_b = 1.0 if cfg.moe.dispatch_int8 else AB
        if cell.kind == "train":
            total_bytes = buf_elems * (2 * fwd_b + 2 * AB)
        else:
            total_bytes = buf_elems * 2 * fwd_b
        coll += n_layers_eff * ring(total_bytes / md.chips, md.tp)

    # "useful" model flops: the core matmul work at the 6ND convention
    # (x3 for backward, NO remat/attention overhead) — so
    # useful_flops_fraction isolates remat + attention + head overheads.
    model_6nd = fwd_core * (3.0 if cell.kind == "train" else 1.0)
    return {"flops_global": flops, "mem_bytes_dev": mem,
            "coll_bytes_dev": coll, "fwd_flops_global": fwd,
            "model_flops_6nd": model_6nd}
