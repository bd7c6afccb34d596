"""Quantized linear layer — the paper's computational scheme (Figure 1):

      y = Ŵ · Q_a(x)  +  U Vᵀ x

Counterpart of ``repro/quant/qlinear.py``.  Execution paths (``impl``):
  sim    — fake-quant float math (plain torch).
  int8   — integer GEMM with per-token rescale (plain torch; the LR term in
           the LR storage dtype).
  pallas — the hand-written kernels through ``kernels/ops.py`` (per-token
           or group-wise activation scales, ``act_group``), on the
           path the layer's :class:`KernelContext` (``ctx``; None → the
           default, ``"auto"``) resolves: fused where the site fits the
           one-kernel path, else chained (prologue → GEMM), or as pinned.
  fused  — the single fused kernel, pinned.

Weight layout is (d_in, d_out) with ``y = x @ w``; ``qweight`` is uint8
(d_in/2, d_out), the low nibble on the even d_in row.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.quantizers import (QuantSpec, fake_quant_act, pack_int4,
                                         quantize_act, unpack_int4)
from repro_torch.kernels.context import KernelContext
from repro_torch.kernels.rowops import int_matmul

KERNEL_IMPLS = ("pallas", "fused")
RETAG_IMPLS = ("sim", "int8", "pallas", "fused", "auto")


@dataclasses.dataclass
class QLinear:
    """One quantized weight matrix + its LRC correction."""

    qweight: torch.Tensor  # uint8 (d_in//2, d_out) — int4 packed along d_in
    w_scale: torch.Tensor  # f32 (d_out,) per-output-channel
    u: Optional[torch.Tensor]  # bf16 (d_out, k) or None
    v: Optional[torch.Tensor]  # bf16 (d_in, k) or None

    bits: int = 4
    act_bits: int = 4
    act_group: Optional[int] = None
    clip_ratio: float = 1.0
    impl: str = "int8"  # sim | int8 | pallas | fused
    name: Optional[str] = None
    ctx: Optional[KernelContext] = None  # kernel paths; None → the default

    @property
    def d_in(self) -> int:
        return self.qweight.shape[-2] * 2

    @property
    def d_out(self) -> int:
        return self.qweight.shape[-1]

    @property
    def act_spec(self) -> QuantSpec:
        return QuantSpec(bits=self.act_bits, clip_ratio=self.clip_ratio,
                         group_size=self.act_group)


def make_qlinear(q_out_in: torch.Tensor, scales: torch.Tensor,
                 u: Optional[torch.Tensor] = None,
                 v: Optional[torch.Tensor] = None, *,
                 act_bits: int = 4, act_group: Optional[int] = None,
                 clip_ratio: float = 1.0, impl: str = "sim",
                 lr_dtype=torch.bfloat16, name: Optional[str] = None) -> QLinear:
    """From the solver's int8 (d_out, d_in) codes and (d_out, 1) scales."""
    q_in_out = q_out_in.to(torch.int8).T  # (d_in, d_out)
    packed = pack_int4(q_in_out.T).T.contiguous()  # pack along d_in
    return QLinear(
        qweight=packed,
        w_scale=scales.to(torch.float32).reshape(-1).contiguous(),
        u=None if u is None else u.to(lr_dtype).contiguous(),
        v=None if v is None else v.to(lr_dtype).contiguous(),
        act_bits=act_bits, act_group=act_group, clip_ratio=clip_ratio,
        impl=impl, name=name)


def _unpack_w(q: QLinear) -> torch.Tensor:
    """packed (d_in//2, d_out) -> int8 (d_in, d_out)."""
    return unpack_int4(q.qweight.T).T


def _lowrank(q: QLinear, x: torch.Tensor) -> torch.Tensor:
    """(x V) Uᵀ on the unquantized activations, in the LR dtype."""
    xv = x.to(q.v.dtype) @ q.v
    return xv @ q.u.T.to(q.v.dtype)


def _apply_sim(q: QLinear, x: torch.Tensor) -> torch.Tensor:
    w = _unpack_w(q).to(torch.float32) * q.w_scale[None, :]
    xq = fake_quant_act(x, q.act_spec).to(torch.float32)
    y = xq @ w
    if q.u is not None:
        y = y + _lowrank(q, x).to(torch.float32)
    return y.to(x.dtype)


def _apply_int8(q: QLinear, x: torch.Tensor) -> torch.Tensor:
    """Integer GEMM path, per-token or per-group activation scales."""
    wq = _unpack_w(q)  # int8 (d_in, d_out)
    xq, sx = quantize_act(x, q.act_spec)
    if q.act_group is None:
        acc = int_matmul(xq, wq)
        y = acc.to(torch.float32) * sx * q.w_scale
    else:
        g = q.act_group
        d_in, d_out = wq.shape
        ng = d_in // g
        xg = xq.reshape(*x.shape[:-1], ng, g).to(torch.float64)
        wg = wq.reshape(ng, g, d_out).to(torch.float64)
        accg = torch.einsum("...nk,nkd->...nd", xg, wg).to(torch.int32)
        y = (accg.to(torch.float32) * sx[..., None]).sum(dim=-2) * q.w_scale
    if q.u is not None:
        y = y + _lowrank(q, x).to(torch.float32)
    return y.to(x.dtype)


def _apply_pallas(q: QLinear, x: torch.Tensor,
                  kernel_impl: Optional[str] = None) -> torch.Tensor:
    """The kernel paths.  ``kernel_impl=None`` defers to ``q.ctx`` (its
    impl, and any override keyed by ``q.name`` or the layer's (K, N, R)
    shape); ``"fused"`` pins the single-kernel path.  The kernels compute
    the (xV)Uᵀ correction in f32 from the bf16-stored factors, so their
    output differs from the int8 path (which multiplies in the LR dtype) by
    ~bf16 epsilon of that term."""
    from repro_torch.kernels import ops

    lead = x.shape[:-1]
    y = ops.w4a4_lrc_forward(x.reshape(-1, x.shape[-1]), q.qweight,
                             q.w_scale, q.u, q.v, act_spec=q.act_spec,
                             impl=kernel_impl, ctx=q.ctx, layer=q.name)
    return y.reshape(*lead, q.d_out).to(x.dtype)


def qlinear_apply(q: QLinear, x: torch.Tensor) -> torch.Tensor:
    if q.impl == "sim":
        return _apply_sim(q, x)
    if q.impl == "int8":
        return _apply_int8(q, x)
    if q.impl in KERNEL_IMPLS:
        return _apply_pallas(q, x, None if q.impl == "pallas" else "fused")
    raise ValueError(f"unknown impl {q.impl!r}")


def apply_linear(w, x: torch.Tensor) -> torch.Tensor:
    """Dispatch: plain tensor → dense matmul; QLinear → W4A4+LRC path."""
    if isinstance(w, QLinear):
        return qlinear_apply(w, x)
    return x @ w.to(x.dtype)


def _first_qlinear(node) -> Optional[QLinear]:
    if isinstance(node, QLinear):
        return node
    children = (node.values() if isinstance(node, dict)
                else node if isinstance(node, list) else ())
    for child in children:
        found = _first_qlinear(child)
        if found is not None:
            return found
    return None


def retag_act_group(params, policy):
    """Every QLinear of a param tree with the activation group
    ``policy.act_group_for(name)`` (a :class:`~repro_torch.quant.policy.
    QuantPolicy`), the tag ``quantize_model`` gives it under that policy.
    RTN with an SVD or no correction reads no statistics, so retagging such
    a model is bitwise the same as quantizing it again with the policy's
    groups."""

    def _retag(node):
        if isinstance(node, QLinear):
            return dataclasses.replace(node, act_group=policy.act_group_for(node.name))
        if isinstance(node, dict):
            return {k: _retag(v) for k, v in node.items()}
        if isinstance(node, list):
            return [_retag(v) for v in node]
        return node

    return _retag(params)


def retag_qlinear_impl(params, impl: Optional[str],
                       ctx: Optional[KernelContext] = None, device=None):
    """Switch every QLinear in a param tree (nested dicts and lists) to
    another execution path and/or attach a :class:`KernelContext` (``ctx``
    None leaves the contexts as they are; ``impl`` None leaves the impls).

    ``"auto"`` resolves here, as the reference resolves it from its
    backend: the kernel paths ("pallas") when the params live on a CUDA
    device — ``device``, or where None the device of the tree's QLinear
    tensors — and otherwise each leaf keeps its calibrated impl."""
    if impl is not None and impl not in RETAG_IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {RETAG_IMPLS}")
    resolved = impl
    if impl == "auto":
        if device is None:
            first = _first_qlinear(params)
            device = None if first is None else first.qweight.device
        resolved = ("pallas" if device is not None
                    and torch.device(device).type == "cuda" else None)
    changes = {} if resolved is None else {"impl": resolved}
    if ctx is not None:
        changes["ctx"] = ctx
    if not changes:
        return params

    def _retag(node):
        if isinstance(node, QLinear):
            return dataclasses.replace(node, **changes)
        if isinstance(node, dict):
            return {k: _retag(v) for k, v in node.items()}
        if isinstance(node, list):
            return [_retag(v) for v in node]
        return node

    return _retag(params)
