"""Model configuration schema for all assigned architectures.

A copy of ``repro.models.config`` (framework-free dataclasses), kept here
so the port imports nothing of ``repro``; ``tests/test_torch_models.py``
holds it equal to the reference's.  One dataclass covers the whole pool:
dense llama-style transformers, GQA/MQA, gemma2 local/global + softcaps,
MoE (granite/qwen3), RG-LRU hybrids (recurrentgemma), RWKV6,
encoder-decoder (whisper) and early-fusion VLM (chameleon).
``configs/<arch>.py`` instantiates the exact published configs;
``smoke()`` derives the reduced same-family variant used by the CPU smoke
tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    expert_d_ff: int
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # §Perf: quantize the dispatch/combine buffers to int8 so the EP
    # all-to-all moves half the bytes (per-token scales ride along).
    dispatch_int8: bool = False


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder tower for enc-dec models (whisper).  The conv/audio frontend
    is a STUB per the assignment: inputs are precomputed frame embeddings."""

    n_layers: int
    n_frames: int            # encoder sequence length (1500 for whisper)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str              # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int             # 0 for attention-free (rwkv)
    n_kv_heads: int
    d_ff: int
    vocab: int
    # --- variants -------------------------------------------------------
    mlp: str = "swiglu"          # swiglu | relu2 | gelu
    head_dim: Optional[int] = None
    rope_theta: float = 10000.0
    attn_softcap: Optional[float] = None     # gemma2: 50.0
    logit_softcap: Optional[float] = None    # gemma2: 30.0
    window: Optional[int] = None             # sliding-window size
    # per-superlayer block pattern; scanned as one unit.  entries:
    #   "ga"  global attention   "la"  local (window) attention
    #   "rg"  RG-LRU recurrent   "rwkv" RWKV6 time+channel mix
    block_pattern: Tuple[str, ...] = ("ga",)
    # layers appended AFTER the scanned stack (for depths not divisible by
    # the pattern, e.g. recurrentgemma-9b: 12 x (rg,rg,la) + (rg,rg)).
    tail_pattern: Tuple[str, ...] = ()
    qk_norm: bool = False                    # chameleon
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    encoder: Optional[EncoderConfig] = None
    # rwkv6
    rwkv_head_dim: int = 64
    # numerics
    dtype: str = "bfloat16"
    remat: bool = True
    # remat policy when remat=True: "full" (nothing saveable — min memory,
    # +1 re-forward) or "dots" (save matmul outputs — recompute only the
    # cheap elementwise ops; §Perf lever for compute-bound cells).
    remat_policy: str = "full"

    # -- derived ----------------------------------------------------------

    @property
    def padded_vocab(self) -> int:
        """Embedding/head tables are padded to a multiple of 256 so the
        vocab dim shards over any TP degree (and tiles the MXU); logits in
        the pad region are masked to -inf (see layers.logits)."""
        return (self.vocab + 255) // 256 * 256

    @property
    def head_dim_(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def n_superlayers(self) -> int:
        scanned = self.n_layers - len(self.tail_pattern)
        assert scanned % len(self.block_pattern) == 0, \
            (self.name, self.n_layers, self.block_pattern)
        return scanned // len(self.block_pattern)

    @property
    def all_blocks(self) -> Tuple[str, ...]:
        return self.block_pattern + self.tail_pattern

    @property
    def attention_free(self) -> bool:
        return all(b == "rwkv" for b in self.all_blocks)

    @property
    def sub_quadratic(self) -> bool:
        """True if no block needs an unbounded full-attention KV cache —
        the long_500k eligibility criterion."""
        return all(b in ("rg", "rwkv", "la") for b in self.all_blocks)

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6*N*D)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim_

        def block_params(b: str) -> int:
            n = 0
            if b in ("ga", "la"):
                n += d * self.n_heads * hd * 2        # wq, wo
                n += d * self.n_kv_heads * hd * 2     # wk, wv
            elif b == "rg":
                n += 4 * d * d                        # x/gate/a,i/out projs
            elif b == "rwkv":
                n += 5 * d * d + 2 * d * f + d * d    # time mix + channel mix
                return n                              # rwkv embeds its FFN
            if self.moe is not None:
                n += (self.moe.n_experts * 3 * d * self.moe.expert_d_ff
                      + d * self.moe.n_experts)
            elif self.mlp == "swiglu":
                n += 3 * d * f
            else:
                n += 2 * d * f
            return n

        layer_seq = (list(self.block_pattern) * self.n_superlayers
                     + list(self.tail_pattern))
        total = sum(block_params(b) for b in layer_seq)
        total += v * d * (1 if self.tie_embeddings else 2)
        if self.encoder is not None:
            enc_per = d * self.n_heads * hd * 2 + d * self.n_kv_heads * hd * 2
            enc_per += 2 * d * f
            total += self.encoder.n_layers * enc_per
            # cross-attention in every decoder layer
            total += self.n_layers * (d * self.n_heads * hd * 2
                                      + d * self.n_kv_heads * hd * 2)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        dense = self.param_count()
        moe_all = self.n_layers * self.moe.n_experts * 3 * d * self.moe.expert_d_ff
        moe_act = self.n_layers * self.moe.top_k * 3 * d * self.moe.expert_d_ff
        return dense - moe_all + moe_act

    def smoke(self) -> "ModelConfig":
        """The reduced same-family config for CPU smoke tests."""
        pat = self.block_pattern
        n_layers = max(len(pat), 2 if len(pat) == 1 else len(pat))
        n_layers += len(self.tail_pattern)
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(self.moe, n_experts=4, top_k=2,
                                      expert_d_ff=32)
        enc = None
        if self.encoder is not None:
            enc = EncoderConfig(n_layers=2, n_frames=16)
        n_heads = min(self.n_heads, 4) if self.n_heads else 0
        n_kv = max(1, min(self.n_kv_heads, n_heads)) if n_heads else 0
        if n_heads and self.n_heads % self.n_kv_heads == 0:
            # preserve the GQA ratio class (grouped vs MQA vs MHA)
            n_kv = 1 if self.n_kv_heads == 1 else (
                n_heads if self.n_kv_heads == self.n_heads else
                max(1, n_heads // 2))
        return dataclasses.replace(
            self, name=self.name + "-smoke", n_layers=n_layers,
            d_model=64, n_heads=n_heads, n_kv_heads=n_kv, d_ff=128,
            vocab=256, head_dim=16 if n_heads else None,
            window=min(self.window, 16) if self.window else None,
            moe=moe, encoder=enc, dtype="float32", remat=False)
