"""LRC — the paper's core algorithm (Algorithms 1-5; counterpart of
``repro/core/lrc.py``).

Solves, per layer,

    min_{Ŵ ∈ C(b), U, V}  || W X − Ŵ Q_a(X) − U Vᵀ X ||²          (eq. 2)

by alternating minimization:

  * Init  (Prop 3.4 / Alg 4):  U ← eig_k(Σ_init),  V ← Wᵀ U, with
        Σ_init = W Σx Wᵀ − Sᵀ S,   S = L_y⁻¹ Σxyᵀ Wᵀ,  L_y = chol(Σy).
  * Ŵ-update (Prop 3.1 / Alg 2): quantize the modified target
        W̃ = (W − U Vᵀ) Σxy Σy⁻¹
    against the hessian of the quantized activations Σy (GPTQ by default).
  * (U,V)-update (Prop 3.3 / Alg 3): closed form —
        Σ = Σ1 + Σ2 − Σ3,
        Σ1 = W Σx Wᵀ,  Σ2 = Sᵀ S with S = L_x⁻¹ Σxy Ŵᵀ,
        Σ3 = Ŵ Σxyᵀ Wᵀ + W Σxy Ŵᵀ,
        U = eig_k(Σ),  V = [Wᵀ − Σx⁻¹ Σxy Ŵᵀ] U.

Matrices are in the paper's convention: W (d_out, d_in); statistics are
(d_in, d_in) second moments from ``core/stats.py``.  Everything runs in
float64 on the device of the statistics, as the reference runs under
``ensure_x64``.  The eigenvectors' signs (and the basis inside a
degenerate eigenspace) depend on the eigensolver; U and V flip together,
so U Vᵀ and the losses are what two solvers agree on.

The calibration-free baselines (RTN, the SVD correction) are at the end.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.gptq import gptq_quantize, rtn_weight_quantize
from repro_torch.core.quantizers import QuantSpec, dequantize_weight
from repro_torch.core.stats import CalibStats

F64 = torch.float64


@dataclasses.dataclass
class LRCResult:
    """Output of the per-layer LRC solve."""

    qweight: torch.Tensor  # int8 (d_out, d_in) carrying b-bit integers
    scales: torch.Tensor  # f32 per-row scales (d_out, 1)
    u: Optional[torch.Tensor]  # f32 (d_out, k)
    v: Optional[torch.Tensor]  # f32 (d_in, k)
    losses: list  # reconstruction loss after each stage
    oracle_loss: float  # loss of the unconstrained-W̃ relaxation (Prop 3.4)


# ---------------------------------------------------------------------------
# linear-algebra helpers (f64)
# ---------------------------------------------------------------------------


def _chol(a):
    return torch.linalg.cholesky(a)


def _tri_solve(l, b, lower=True, trans=False):
    """Solve op(L) z = b for triangular L, op = transpose when ``trans``
    (the reference's ``solve_triangular(l, b, lower=, trans=)``)."""
    if trans:
        return torch.linalg.solve_triangular(l.mT, b, upper=lower)
    return torch.linalg.solve_triangular(l, b, upper=not lower)


def _chol_solve(l, b):
    """Solve A z = b given lower Cholesky factor l of A."""
    return _tri_solve(l, _tri_solve(l, b, lower=True), lower=True, trans=True)


def _eig_topk(sigma: torch.Tensor, k: int) -> torch.Tensor:
    """k unit eigenvectors for the k largest eigenvalues (Σ is symmetric
    but possibly indefinite; plain eigh ordering suffices)."""
    sigma = 0.5 * (sigma + sigma.T)
    _, vecs = torch.linalg.eigh(sigma)  # ascending
    return vecs.flip(-1)[:, :k]


# ---------------------------------------------------------------------------
# Algorithm 4 — Init-LR
# ---------------------------------------------------------------------------


def init_lr(w: torch.Tensor, stats: CalibStats, k: int):
    """Returns (U, V) from the relaxed problem (Prop 3.4)."""
    w = w.to(F64)
    sigma1 = w @ stats.sxx @ w.T
    ly = _chol(stats.syy)
    s = _tri_solve(ly, stats.sxy.T @ w.T, lower=True)  # L_y⁻¹ Σxyᵀ Wᵀ
    u = _eig_topk(sigma1 - s.T @ s, k)
    return u, w.T @ u


# ---------------------------------------------------------------------------
# Algorithm 2 — Update-Quant (Prop 3.1)
# ---------------------------------------------------------------------------


def modified_target(w, u, v, stats: CalibStats):
    """W̃ = (W − U Vᵀ) Σxy Σy⁻¹ — the unconstrained-optimal weight acting on
    quantized activations given the current low-rank pair."""
    w = w.to(F64)
    resid = w if u is None else w - u @ v.T
    ly = _chol(stats.syy)
    return _chol_solve(ly, stats.sxy.T @ resid.T).T  # W̃ᵀ = Σy⁻¹ Σxyᵀ residᵀ


def update_quant(w, u, v, stats: CalibStats, spec: QuantSpec,
                 method: str = "gptq"):
    """Returns (qweight int8, scales, Ŵ dequantized f64)."""
    wt = modified_target(w, u, v, stats)
    if method == "gptq":
        q, s = gptq_quantize(wt, stats.syy, spec)
    elif method == "rtn":
        q, s = rtn_weight_quantize(wt, None, spec)
    else:
        raise ValueError(f"unknown quant method {method!r}")
    return q, s, dequantize_weight(q, s.to(F64), spec)


# ---------------------------------------------------------------------------
# Algorithm 3 — Update-LR (Prop 3.3)
# ---------------------------------------------------------------------------


def update_lr(w, w_hat, stats: CalibStats, k: int):
    """Closed-form (U, V) given the current quantized Ŵ."""
    w = w.to(F64)
    w_hat = w_hat.to(F64)
    sigma1 = w @ stats.sxx @ w.T
    sigma3 = w_hat @ stats.sxy.T @ w.T + w @ stats.sxy @ w_hat.T
    lx = _chol(stats.sxx)
    s = _tri_solve(lx, stats.sxy @ w_hat.T, lower=True)  # L_x⁻¹ Σxy Ŵᵀ
    u = _eig_topk(sigma1 + s.T @ s - sigma3, k)
    z = _chol_solve(lx, stats.sxy @ w_hat.T)  # Σx⁻¹ Σxy Ŵᵀ
    return u, (w.T - z) @ u  # V = [Wᵀ − Σx⁻¹ Σxy Ŵᵀ] U


# ---------------------------------------------------------------------------
# Reconstruction loss (closed form from the statistics)
# ---------------------------------------------------------------------------


def reconstruction_loss(w, stats: CalibStats, w_hat=None, u=None,
                        v=None) -> float:
    """|| W X − Ŵ Y − U Vᵀ X ||² expanded in the second moments, per
    calibration token.  ``w_hat=None`` drops the quantized term; ``u=None``
    drops the LR term."""
    w = w.to(F64)
    total = torch.trace(w @ stats.sxx @ w.T)
    if w_hat is not None:
        w_hat = w_hat.to(F64)
        total = total + torch.trace(w_hat @ stats.syy @ w_hat.T)
        total = total - 2.0 * torch.trace(w @ stats.sxy @ w_hat.T)
    if u is not None:
        u = u.to(F64)
        v = v.to(F64)
        total = total + torch.trace((v.T @ stats.sxx @ v) @ (u.T @ u))
        total = total - 2.0 * torch.trace(u.T @ w @ stats.sxx @ v)
        if w_hat is not None:
            total = total + 2.0 * torch.trace(u.T @ w_hat @ stats.sxy.T @ v)
    return float(total / torch.clamp_min(stats.count, 1.0))


# ---------------------------------------------------------------------------
# Algorithm 1 — full LRC
# ---------------------------------------------------------------------------


def lrc_solve(w: torch.Tensor, stats: CalibStats, spec: QuantSpec, k: int,
              iters: int = 1, quant_method: str = "gptq") -> LRCResult:
    """Alternating minimization (Algorithm 1); ``iters`` = T."""
    w = w.to(F64)
    losses = []
    u, v = init_lr(w, stats, k)
    # oracle: unconstrained W̃ with the init (U, V) — Prop 3.4's relaxation
    wt0 = modified_target(w, u, v, stats)
    oracle = reconstruction_loss(w, stats, w_hat=wt0, u=u, v=v)
    q = s = None
    for _ in range(max(1, iters)):
        q, s, w_hat = update_quant(w, u, v, stats, spec, method=quant_method)
        losses.append(reconstruction_loss(w, stats, w_hat=w_hat, u=u, v=v))
        u, v = update_lr(w, w_hat, stats, k)
        losses.append(reconstruction_loss(w, stats, w_hat=w_hat, u=u, v=v))
    return LRCResult(qweight=q, scales=s, u=u.to(torch.float32),
                     v=v.to(torch.float32), losses=losses, oracle_loss=oracle)


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------


def quantize_baseline(w, stats: CalibStats, spec: QuantSpec,
                      quant_method: str = "gptq", hessian: str = "x"):
    """QuaRot-style baseline: GPTQ or RTN quantization of W (d_out, d_in),
    no low-rank term.  ``hessian='x'`` uses the unquantized activations'
    Σx (the QuaRot codebase), ``'y'`` the quantized ones' Σy.  RTN reads no
    statistics (``stats`` may be None).  Returns (q int8, scales f32, Ŵ
    f64)."""
    w = w.to(F64)
    if quant_method == "gptq":
        q, s = gptq_quantize(w, stats.sxx if hessian == "x" else stats.syy, spec)
    else:
        q, s = rtn_weight_quantize(w, None, spec)
    return q, s, dequantize_weight(q, s.to(F64), spec)


def svd_correction(w, w_hat, k: int):
    """The paper's 'SVD' baseline: rank-k SVD of the weight residual W − Ŵ,
    ignoring activation statistics.  Returns (u (d_out, k), v (d_in, k))."""
    resid = w.to(F64) - w_hat.to(F64)
    uu, ss, vvt = torch.linalg.svd(resid, full_matrices=False)
    root = torch.sqrt(ss[:k])
    return uu[:, :k] * root[None, :], vvt[:k, :].T * root[None, :]
