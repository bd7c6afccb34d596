"""Calibration-free baselines of the LRC solver (counterpart of the
baseline section of ``repro/core/lrc.py``): RTN weight quantization and the
paper's SVD correction.  Algorithm 1 (``lrc_solve``) and GPTQ need the
activation statistics and come with a later slice.

The solvers run in float64, as the reference does under ``ensure_x64``.
"""

from __future__ import annotations

import torch

from repro_torch.core.quantizers import (QuantSpec, dequantize_weight,
                                         quantize_weight_rtn)


def quantize_baseline(w, stats, spec: QuantSpec, quant_method: str = "gptq",
                      hessian: str = "x"):
    """RTN quantization of W (d_out, d_in), no low-rank term.  Returns
    (q int8, scales f32, Ŵ f64).  ``stats`` and ``hessian`` are accepted for
    the reference's signature; the RTN branch does not read them."""
    if quant_method != "rtn":
        raise NotImplementedError(
            f"quant_method {quant_method!r} needs activation statistics; only "
            f"'rtn' is ported (GPTQ comes with the calibration slice)")
    w = w.to(torch.float64)
    # the reference's RTN casts to f32 before scaling (core/gptq.py)
    q, s = quantize_weight_rtn(w.to(torch.float32), spec)
    w_hat = dequantize_weight(q, s.to(torch.float64), spec)
    return q, s, w_hat


def svd_correction(w, w_hat, k: int):
    """The paper's 'SVD' baseline: rank-k SVD of the weight residual W − Ŵ,
    ignoring activation statistics.  Returns (u (d_out, k), v (d_in, k))."""
    resid = w.to(torch.float64) - w_hat.to(torch.float64)
    uu, ss, vvt = torch.linalg.svd(resid, full_matrices=False)
    root = torch.sqrt(ss[:k])
    u = uu[:, :k] * root[None, :]
    v = vvt[:k, :].T * root[None, :]
    return u, v
