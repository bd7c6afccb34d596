"""QuaRot-style rotation fusion math (LRC stage 1; counterpart of
``repro/core/rotation.py``).

For a pre-norm transformer with RMSNorm, an orthogonal rotation R of the
residual stream fuses into the weights with exact output preservation:
fold each RMSNorm γ into the linears that read it (the norm becomes a pure
RMS, which commutes with R), then rotate readers (W ← W R), writers
(W ← Rᵀ W), the embedding rows (E ← E R) and the head.  Products run in
f32 and round back to the weight's dtype, as the reference's do.
``quant/rotate.py`` applies this to a model.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hadamard import hadamard_matrix

F32 = torch.float32


def residual_rotation(d: int, seed: int = 0, device="cpu") -> torch.Tensor:
    """The fused R1 rotation for a residual stream of width d (float32)."""
    return torch.as_tensor(hadamard_matrix(d, seed), dtype=F32, device=device)


def rotate_in(w: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Reader weight W (d_out, d_in): x is replaced by Rᵀx ⇒ W ← W R."""
    return (w.to(F32) @ r).to(w.dtype)


def rotate_out(w: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Writer weight W (d_out, d_in) into the residual ⇒ W ← Rᵀ W."""
    return (r.T @ w.to(F32)).to(w.dtype)


def rotate_embedding(e: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Embedding table (vocab, d): rows live in the residual stream ⇒ E ← E R."""
    return (e.to(F32) @ r).to(e.dtype)


def fold_rmsnorm_gamma(gamma: torch.Tensor, readers: list) -> tuple:
    """Fold γ into every reader weight (W ← W diag(γ)); returns (ones, new
    readers)."""
    g = gamma.to(F32)
    new = [(w.to(F32) * g[None, :]).to(w.dtype) for w in readers]
    return torch.ones_like(gamma), new


def incoherence(w) -> float:
    """max|W_ij| · sqrt(numel) / ||W||_F — the outlier measure rotations are
    meant to reduce (QuaRot §3)."""
    w = (w.detach().cpu().double().numpy() if isinstance(w, torch.Tensor)
         else np.asarray(w, np.float64))
    return float(np.abs(w).max() * np.sqrt(w.size) / np.linalg.norm(w))
