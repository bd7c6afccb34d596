"""Online calibration statistics (Algorithm 1, lines 3-5; counterpart of
``repro/core/stats.py``).

LRC never materializes the activation matrix X; it accumulates the second
moments

    Σx  = Σ_t x_t x_tᵀ        (d_in, d_in)
    Σy  = Σ_t y_t y_tᵀ        y = Q_a(x)
    Σxy = Σ_t x_t y_tᵀ

over calibration batches, in float64 (paper: "computation of these matrices
required 64-bit precision").  Each batch is three f64 ``torch.matmul``s on
the device of the activations.  Data-parallel accumulation (the reference's
``axis_name`` psum) comes with the distributed slice.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.quantizers import QuantSpec, dequantize_act, quantize_act
from repro_torch.kernels.rowops import scalar

F64 = torch.float64


@dataclasses.dataclass
class CalibStats:
    """Accumulated second moments (float64, on one device)."""

    sxx: torch.Tensor  # (d, d)
    syy: torch.Tensor  # (d, d)
    sxy: torch.Tensor  # (d, d)
    count: torch.Tensor  # () number of tokens seen

    @property
    def d(self) -> int:
        return self.sxx.shape[0]

    def to(self, device) -> "CalibStats":
        return CalibStats(*(getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)))


def init_stats(d: int, device="cpu") -> CalibStats:
    z = torch.zeros((d, d), dtype=F64, device=device)
    return CalibStats(sxx=z, syy=z, sxy=z,
                      count=torch.zeros((), dtype=F64, device=device))


def accumulate_stats(stats: CalibStats, x: torch.Tensor,
                     spec: QuantSpec) -> CalibStats:
    """Fold a batch of activations x (..., d) into the statistics.  Q_a runs
    on the f64 rows (true division, round half to even, amax <= 0 → 1)."""
    x = x.reshape(-1, x.shape[-1]).to(F64)
    q, s = quantize_act(x, spec)
    y = dequantize_act(q, s, spec).to(F64)
    return CalibStats(
        sxx=stats.sxx + x.T @ x,
        syy=stats.syy + y.T @ y,
        sxy=stats.sxy + x.T @ y,
        count=stats.count + x.shape[0],
    )


def finalize_stats(stats: CalibStats, eps_frac: float = 1e-2) -> CalibStats:
    """Add the paper's damping:  Σ ← Σ + (eps_frac/d)·Tr(Σ)·I  (§3)."""
    d = stats.d
    eye = torch.eye(d, dtype=F64, device=stats.sxx.device)
    ex = eps_frac * torch.trace(stats.sxx) / scalar(d, eye)
    ey = eps_frac * torch.trace(stats.syy) / scalar(d, eye)
    return CalibStats(sxx=stats.sxx + ex * eye, syy=stats.syy + ey * eye,
                      sxy=stats.sxy, count=stats.count)
