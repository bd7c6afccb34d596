"""GPTQ layer-wise quantization solver (Frantar et al., 2022; counterpart
of ``repro/core/gptq.py``).

The subroutine of LRC's Ŵ-update (paper Alg. 2, line 5).  It needs the
target weight matrix and the (damped) input second moment H:

    min_{Ŵ ∈ C(b)}  || (W - Ŵ) X ||²   with  H = X Xᵀ.

Cholesky form: with T the upper-triangular factor of H⁻¹ (H⁻¹ = Tᵀ T),
quantize column i, then propagate the scaled residual to the columns j > i
through row T[i, :].

  * :func:`gptq_quantize` — the reference's column-serial scan as a Python
    loop over the d_in columns, in float64 on the weight's device.  The
    reference updates the whole carry under a mask that is exactly 0 at
    rows ≤ i; updating only rows i+1… gives the same codes.  Each update
    is a product then a subtraction (two roundings, never fused).
  * :func:`gptq_quantize_np` — the blocked float64 numpy form (the official
    algorithm's structure), a test oracle; its sums are grouped
    differently from the scan's.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quantizers import QuantSpec, quantize_weight_rtn, weight_scales

F64 = torch.float64


def _hinv_chol_upper(h: torch.Tensor, damp: float) -> torch.Tensor:
    """Upper-triangular T with H⁻¹ = Tᵀ T (after damping)."""
    d = h.shape[0]
    eye = torch.eye(d, dtype=h.dtype, device=h.device)
    h = h + damp * torch.mean(torch.diag(h)) * eye
    l = torch.linalg.cholesky(h)
    linv = torch.linalg.solve_triangular(l, eye, upper=False)
    hinv = linv.T @ linv  # H⁻¹ = L⁻ᵀ L⁻¹
    return torch.linalg.cholesky(hinv).T


def _gptq_scan(wt: torch.Tensor, t_upper: torch.Tensor, scales: torch.Tensor,
               bits: int) -> torch.Tensor:
    """wt: (d_in, d_out) transposed weights (f64); t_upper: (d_in, d_in);
    scales: (d_out,).  Returns the codes (d_in, d_out) int8."""
    qmax = 2 ** (bits - 1) - 1
    qmin = -(2 ** (bits - 1))
    d_in = wt.shape[0]
    w = wt.clone()
    codes = torch.empty(wt.shape, dtype=torch.int8, device=wt.device)
    for i in range(d_in):
        col = w[i]  # (d_out,) current (residual-corrected) column i
        q = torch.clamp(torch.round(col / scales), qmin, qmax)
        codes[i] = q.to(torch.int8)
        if i + 1 < d_in:
            err = (col - q * scales) / t_upper[i, i]
            w[i + 1:] -= t_upper[i, i + 1:, None] * err[None, :]
    return codes


def gptq_quantize(w: torch.Tensor, hessian: torch.Tensor, spec: QuantSpec,
                  damp: float = 0.01, act_order: bool = False):
    """Quantize ``w`` (d_out, d_in) against ``hessian`` (d_in, d_in).

    Returns (q int8 (d_out, d_in), scales f32 (d_out, 1)).  ``act_order``:
    process columns in order of decreasing hessian diagonal (GPTQ's
    ``desc_act``; ties keep their order)."""
    w = w.to(F64)
    h = hessian.to(F64)
    d_in = w.shape[1]

    # dead inputs: a zero hessian diagonal means the column never activates
    dead = torch.diag(h) <= 0.0
    eye = torch.eye(d_in, dtype=torch.bool, device=h.device)
    one = torch.ones((), dtype=F64, device=h.device)
    h = torch.where(eye & dead[None, :], one, h)
    w = torch.where(dead[None, :], torch.zeros_like(one), w)

    perm = None
    if act_order:
        perm = torch.argsort(-torch.diag(h), stable=True)
        w = w[:, perm]
        h = h[perm][:, perm]

    scales = weight_scales(w, spec).to(F64)[:, 0]  # per row
    t_upper = _hinv_chol_upper(h, damp)
    q = _gptq_scan(w.T, t_upper, scales, spec.bits).T  # (d_out, d_in)
    if perm is not None:
        q = q[:, torch.argsort(perm)]
    return q.contiguous(), scales[:, None].to(torch.float32)


def gptq_quantize_np(w: np.ndarray, hessian: np.ndarray, spec: QuantSpec,
                     damp: float = 0.01, block: int = 128):
    """Blocked float64 numpy reference (official GPTQ structure)."""
    w = np.array(w, np.float64)
    h = np.array(hessian, np.float64)
    d_out, d_in = w.shape
    qmax = 2 ** (spec.bits - 1) - 1
    qmin = -(2 ** (spec.bits - 1))

    dead = np.diag(h) <= 0
    h[dead, dead] = 1.0
    w[:, dead] = 0.0
    h = h + damp * np.mean(np.diag(h)) * np.eye(d_in)

    amax = np.abs(w).max(axis=1, keepdims=True)
    amax[amax <= 0] = 1.0
    scales = amax / qmax  # (d_out, 1)

    l = np.linalg.cholesky(h)
    linv = np.linalg.solve(l, np.eye(d_in))
    hinv = linv.T @ linv
    t = np.linalg.cholesky(hinv).T  # upper

    q_out = np.zeros_like(w)
    for b0 in range(0, d_in, block):
        b1 = min(b0 + block, d_in)
        wblk = w[:, b0:b1].copy()
        err = np.zeros_like(wblk)
        for i in range(b1 - b0):
            col = wblk[:, i]
            q = np.clip(np.round(col / scales[:, 0]), qmin, qmax)
            q_out[:, b0 + i] = q
            e = (col - q * scales[:, 0]) / t[b0 + i, b0 + i]
            wblk[:, i:] -= np.outer(e, t[b0 + i, b0 + i:b1])
            err[:, i] = e
        w[:, b1:] -= err @ t[b0:b1, b1:]
    return q_out.astype(np.int8), scales.astype(np.float32)


def rtn_weight_quantize(w: torch.Tensor, hessian, spec: QuantSpec):
    """Hessian-free round-to-nearest (the paper's Fig. 3 'RTN' ablation):
    the weight is cast to f32 first, as the reference does."""
    return quantize_weight_rtn(w.to(torch.float32), spec)
