"""Plain-torch oracles for the W4A4+LRC kernels (counterpart of
``repro/kernels/ref.py``, per-token scales).

The rotation here is the reference oracle's: ``core/hadamard.fwht``, which
divides by ``sqrt(d)``.  The kernels and their plain versions multiply by
``1 / sqrt(d)`` (``rowops.fwht_rows``), which differs in the last bit when
d is 2·4^k, so the rotated oracles hold them only to a tolerance."""

from __future__ import annotations

import torch

from repro_torch.core.hadamard import fwht
from repro_torch.core.quantizers import unpack_int4
from repro_torch.kernels.rowops import int_matmul, scalar


def w4a4_lowrank_matmul_ref(xq, sx, wpacked, sw, xv=None, u=None):
    """Int GEMM, rescale, optional LR term."""
    wq = unpack_int4(wpacked.T).T  # (K, N) int8, even/odd interleave along K
    acc = int_matmul(xq, wq)  # exact integer accumulation
    out = acc.to(torch.float32) * sx * sw
    if xv is not None:
        out = out + xv.to(torch.float32) @ u.to(torch.float32).T
    return out


def act_quant_ref(x, bits: int = 4, clip_ratio: float = 1.0):
    qmax = 2 ** (bits - 1) - 1
    x = x.to(torch.float32)
    amax = x.abs().amax(dim=-1, keepdim=True)
    amax = torch.where(amax <= 0.0, torch.ones_like(amax), amax)
    s = scalar(clip_ratio, amax) * amax / scalar(qmax, amax)
    q = torch.clamp(torch.round(x / s), -qmax - 1, qmax).to(torch.int8)
    return q, s


def fwht_ref(x):
    """The normalized Walsh-Hadamard transform of the f32 rows of x, in x's
    dtype (the dividing form)."""
    return fwht(x.to(torch.float32)).to(x.dtype)


def fused_prologue_ref(x, v=None, bits: int = 4, clip_ratio: float = 1.0,
                       rotate: bool = False):
    """WHT rotation (optional), per-token quantization and the (x·V)
    projection, back to back."""
    x = x.to(torch.float32)
    if rotate:
        x = fwht_ref(x)
    q, s = act_quant_ref(x, bits=bits, clip_ratio=clip_ratio)
    xv = None if v is None else x @ v.to(torch.float32)
    return q, s, xv


def w4a4_lrc_forward_ref(x, wpacked, w_scale, u=None, v=None, bits: int = 4,
                         clip_ratio: float = 1.0, rotate: bool = False):
    """End-to-end oracle: prologue reference chained into the GEMM
    reference."""
    xq, sx, xv = fused_prologue_ref(x, v, bits=bits, clip_ratio=clip_ratio,
                                    rotate=rotate)
    return w4a4_lowrank_matmul_ref(xq, sx, wpacked, w_scale.reshape(1, -1),
                                   xv, u)
