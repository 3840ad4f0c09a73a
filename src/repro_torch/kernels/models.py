"""The model substrate's two kernels: wrappers over ``csrc/models.cu``.

Each wrapper replaces one Pallas kernel of ``repro.kernels``:

* ``flash_attention`` — blocked online-softmax attention with GQA/MQA,
  causal masking, a sliding window and the gemma2 softcap
  (``repro.kernels.flash_attention``): bf16 on the tensor cores
  (``flash_attention_tc_kernel``), fp32 on the CUDA cores
  (``flash_attention_simt_kernel``), both counted as ``flash_attention``
  and told apart by ``symbol_launches``;
* ``rglru_scan``      — the RG-LRU linear recurrence with an fp32 carry
  (``repro.kernels.rglru_scan``).

Dispatch is by the device of the tensors given, as in
``kernels.coherency_step``: on the CPU a wrapper runs its plain version
(``kernels.ref``); on a CUDA device it checks device, dtype, shape and
contiguity, launches its kernel on the current stream (adding one to
``launches[name]``) and raises if the launch fails.  There is no fallback
from the card to the plain version.  Neither kernel has a backward: on
the card a wrapper refuses an input that requires grad while grad mode
is on, rather than return an output cut off from the graph (training
takes the plain path, ``use_kernel=False``).

What bounds each kernel on the card, and how its design answers it, is
noted beside each kernel in ``csrc/models.cu``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import ref
from .build import Library, refuse_dtensor
from .coherency_step import _check

#: the input dtypes the kernels take, as the CUDA entry points number them.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the head dims ``flash_attention`` is built for on the card.
HEAD_DIMS = (16, 32, 64, 128, 256)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGS = {
    "models_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                               _F, _I, _I),
    "models_flash_attention_tc": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _F, _F, _I, _I),
    "models_rglru_scan": (_P, _P, _P, _I, _I, _I, _I),
}
_LIB = Library("models", _SIGS, ("flash_attention", "rglru_scan"))
#: kernel launches per wrapper since the last ``reset_launches()``.
launches: Dict[str, int] = _LIB.launches
#: launches per C entry point since the last ``reset_launches()``: bf16
#: attention is ``models_flash_attention_tc``, fp32 ``models_flash_attention``.
symbol_launches: Dict[str, int] = _LIB.symbol_launches
reset_launches = _LIB.reset_launches
_launch = _LIB.launch


def _check_dtype(name: str, t: torch.Tensor) -> None:
    if t.dtype not in DTYPES:
        raise TypeError(f"{name}: dtype {t.dtype}, expected float32 or "
                        f"bfloat16")


def _no_grad_needed(name: str, *ts: torch.Tensor) -> None:
    """Refuse a CUDA input that requires grad while grad mode is on: the
    kernels have no backward, so their output would be cut off from the
    graph and the layers before them would get no gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            f"{name}: an input requires grad, and the CUDA kernel has no "
            f"backward; training takes use_kernel=False, as loss_fn does "
            f"(or run the kernel under torch.no_grad())")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """[B, Hq, Sq, D] in ``q``'s dtype: attention of ``q`` over ``k``,
    ``v`` ([B, Hkv, Sk, D], ``Hq % Hkv == 0``), queries aligned to the end
    of the keys, scale ``D ** -0.5``.  On the card q, k and
    v share one dtype (float32 or bfloat16) and are contiguous, and D is
    one of ``HEAD_DIMS``; bf16 runs on the tensor cores, with p rounded to
    bf16 before its product with v, and its tensors start at 16-byte
    boundaries (TMA's rule)."""
    refuse_dtensor("flash_attention", q, k, v)
    if q.device.type == "cpu":
        # the Pallas kernel returns q's dtype, its oracle v's.
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap).to(q.dtype)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape or \
            k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] or \
            k.shape[1] == 0 or q.shape[1] % k.shape[1]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; expected "
                         f"[B, Hq, Sq, D] and [B, Hkv, Sk, D] with "
                         f"Hq % Hkv == 0")
    _no_grad_needed("flash_attention", q, k, v)
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D}, expected one of "
                         f"{HEAD_DIMS}")
    _check_dtype("flash_attention", q)
    for t in (q, k, v):
        _check("flash_attention", t, q.dtype, q.device)
    if window is not None and window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap {softcap} <= 0")
    sym = "models_flash_attention"
    if q.dtype == torch.bfloat16:
        sym = "models_flash_attention_tc"
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("flash_attention: bf16 q, k and v must start "
                             "at 16-byte boundaries")
    out = torch.empty_like(q)
    _launch("flash_attention", sym, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), B, Hq, Hkv, Sq, Sk, D,
            float(D) ** -0.5, 0.0 if softcap is None else float(softcap),
            int(causal), -1 if window is None else int(window))
    return out


def rglru_scan(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """[B, S, D] in ``x``'s dtype: ``h_t = a_t h_{t-1} + sqrt(max(1 -
    a_t^2, 0)) x_t`` from ``h_{-1} = 0``, carried in fp32.  On the card
    x and a share one dtype (float32 or bfloat16) and are contiguous."""
    refuse_dtensor("rglru_scan", x, a)
    if x.device.type == "cpu":
        return ref.rglru_scan_ref(x, a)
    if x.dim() != 3 or a.shape != x.shape:
        raise ValueError(f"rglru_scan: x {tuple(x.shape)}, a "
                         f"{tuple(a.shape)}; expected two [B, S, D]")
    _no_grad_needed("rglru_scan", x, a)
    _check_dtype("rglru_scan", x)
    for t in (x, a):
        _check("rglru_scan", t, x.dtype, x.device)
    B, S, D = x.shape
    out = torch.empty_like(x)
    _launch("rglru_scan", "models_rglru_scan", x.data_ptr(), a.data_ptr(),
            out.data_ptr(), DTYPES[x.dtype], B, S, D)
    return out
