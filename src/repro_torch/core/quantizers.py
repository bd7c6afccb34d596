"""Quantization operators Q_b (weights) and Q_a (activations), in torch.

Counterpart of ``repro/core/quantizers.py``: the same scale-then-round
scheme, the same operation order, the same int4 packing.

Conventions (code, tokens-first):
  activations  x : (..., d_in)          — quantized per-token (last axis) or
                                          per group of ``group_size`` features.
  weights      W : (d_out, d_in)        — quantized per-row (output channel).
  int4 grid: integers in [-8, 7] for b=4.

Scalars enter arithmetic as 0-d tensors of the operand's dtype
(``rowops.scalar``), so that bf16 inputs round where the reference rounds
and a division stays a division on CUDA.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels.rowops import scalar


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Static description of a quantization scheme."""

    bits: int = 4
    # Activation clip ratio c (paper §2). 1.0 = plain absmax.
    clip_ratio: float = 1.0
    # Optional groupsize along the feature axis. None = per-token (acts) /
    # per-channel (weights).
    group_size: Optional[int] = None
    symmetric: bool = True

    @property
    def qmax(self) -> int:
        return 2 ** (self.bits - 1) - 1

    @property
    def qmin(self) -> int:
        return -(2 ** (self.bits - 1))

    @property
    def storage_dtype(self):
        return torch.int8 if self.bits <= 8 else torch.int32


def _safe_scale(amax: torch.Tensor, qmax: int) -> torch.Tensor:
    """absmax -> positive scale, guarding all-zero slices."""
    amax = torch.where(amax <= 0.0, scalar(1.0, amax), amax)
    return amax / scalar(qmax, amax)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def weight_scales(w: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Per-output-channel (row) scales, shape (d_out, 1); or per-group
    (d_out, d_in // g) when ``spec.group_size`` is set."""
    if spec.group_size is None:
        amax = w.abs().amax(dim=1, keepdim=True)
        return _safe_scale(amax, spec.qmax)
    g = spec.group_size
    d_out, d_in = w.shape
    if d_in % g:
        raise ValueError(f"group {g} must divide d_in={d_in}")
    amax = w.reshape(d_out, d_in // g, g).abs().amax(dim=-1)
    return _safe_scale(amax, spec.qmax)


def quantize_weight_rtn(w: torch.Tensor, spec: QuantSpec,
                        scales: Optional[torch.Tensor] = None):
    """Round-to-nearest weight quantization.

    Returns (q int8 carrying b-bit integers, scales float32)."""
    if scales is None:
        scales = weight_scales(w, spec)
    if spec.group_size is None:
        ws = w / scales
    else:
        g = spec.group_size
        d_out, d_in = w.shape
        ws = (w.reshape(d_out, d_in // g, g) / scales[..., None]).reshape(d_out, d_in)
    q = torch.clamp(torch.round(ws), spec.qmin, spec.qmax).to(spec.storage_dtype)
    return q, scales.to(torch.float32)


def dequantize_weight(q: torch.Tensor, scales: torch.Tensor, spec: QuantSpec):
    if spec.group_size is None:
        return q.to(scales.dtype) * scales
    g = spec.group_size
    d_out, d_in = q.shape
    w = q.reshape(d_out, d_in // g, g).to(scales.dtype) * scales[..., None]
    return w.reshape(d_out, d_in)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int4 values held in int8 (range [-8, 7]) two-per-byte along the
    LAST axis: out[..., i] holds (q[..., 2i] | q[..., 2i+1] << 4) as uint8."""
    if q.shape[-1] % 2:
        raise ValueError(f"pack_int4 needs an even last axis, got {q.shape}")
    u = (q.to(torch.int32) & 0xF).to(torch.uint8)
    lo = u[..., 0::2]
    hi = u[..., 1::2]
    return lo | (hi << 4)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`; returns int8 values in [-8, 7].  The
    sign is restored as (u XOR 8) - 8."""
    lo = ((packed & 0xF) ^ 8).to(torch.int8) - 8
    hi = (((packed >> 4) & 0xF) ^ 8).to(torch.int8) - 8
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * 2)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def act_scales(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Dynamic scales for the on-the-fly quantizer Q_a.

    per-token: (..., 1); per-group: (..., d // g)."""
    if spec.group_size is None:
        amax = x.abs().amax(dim=-1, keepdim=True)
    else:
        g = spec.group_size
        d = x.shape[-1]
        if d % g:
            raise ValueError(f"group {g} must divide d={d}")
        amax = x.reshape(*x.shape[:-1], d // g, g).abs().amax(dim=-1)
    return _safe_scale(scalar(spec.clip_ratio, amax) * amax, spec.qmax)


def quantize_act(x: torch.Tensor, spec: QuantSpec):
    """Q_a: returns (q int8, scales f32). Values clipped to the int grid."""
    scales = act_scales(x, spec)
    if spec.group_size is None:
        xs = x / scales
    else:
        g = spec.group_size
        d = x.shape[-1]
        xs = (x.reshape(*x.shape[:-1], d // g, g) / scales[..., None]).reshape(x.shape)
    q = torch.clamp(torch.round(xs), spec.qmin, spec.qmax).to(spec.storage_dtype)
    return q, scales.to(torch.float32)


def dequantize_act(q: torch.Tensor, scales: torch.Tensor, spec: QuantSpec):
    if spec.group_size is None:
        return q.to(scales.dtype) * scales
    g = spec.group_size
    d = q.shape[-1]
    x = q.reshape(*q.shape[:-1], d // g, g).to(scales.dtype) * scales[..., None]
    return x.reshape(q.shape)


def fake_quant_act(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Quantize-dequantize in the input dtype (simulation path)."""
    q, s = quantize_act(x.to(torch.float32), spec)
    return dequantize_act(q, s, spec).to(x.dtype)
