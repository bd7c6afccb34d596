"""Hadamard / orthogonal rotations (QuaRot-style preprocessing;
counterpart of ``repro/core/hadamard.py``).

The matrices are built in numpy exactly as the reference builds them (the
port keeps its own copy), so they agree bitwise:

  * Sylvester Hadamard matrices for power-of-two sizes,
  * Paley-I Hadamard matrices for sizes p+1 with p prime, p ≡ 3 (mod 4),
  * seeded random orthogonal factors for odd parts with no Hadamard matrix
    (QuaRot's random-orthogonal variant).

A dimension d is factored as d = m · 2^k with m odd; the rotation is
R = Q_m ⊗ H_{2^k} (normalized).  :func:`fwht` and :func:`apply_rotation`
apply it to torch tensors without materializing R (plain torch: the TPU's
``fwht_kernel`` is not ported yet).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def _split_pow2(n: int):
    """n -> (m, 2^k) with m odd."""
    k = 0
    while n % 2 == 0:
        n //= 2
        k += 1
    return n, 1 << k


@lru_cache(maxsize=None)
def _sylvester(n: int) -> np.ndarray:
    if not _is_pow2(n):
        raise ValueError(f"Sylvester Hadamard needs a power of two, got {n}")
    h = np.array([[1.0]])
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


def _legendre(a: int, p: int) -> int:
    a %= p
    if a == 0:
        return 0
    r = pow(a, (p - 1) // 2, p)
    return 1 if r == 1 else -1


@lru_cache(maxsize=None)
def _paley1(p: int) -> np.ndarray:
    """Paley type-I Hadamard matrix of order p+1 (p prime, p ≡ 3 mod 4)."""
    if p % 4 != 3:
        raise ValueError(f"Paley-I needs p ≡ 3 (mod 4), got {p}")
    q = np.array([[_legendre(i - j, p) for j in range(p)] for i in range(p)], float)
    s = np.zeros((p + 1, p + 1))
    s[0, 1:] = 1.0
    s[1:, 0] = -1.0
    s[1:, 1:] = q
    return s + np.eye(p + 1)


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    for f in range(2, int(n**0.5) + 1):
        if n % f == 0:
            return False
    return True


def random_orthogonal(n: int, seed: int = 0) -> np.ndarray:
    """Seeded random orthogonal matrix (QR of a Gaussian), float64."""
    rng = np.random.default_rng(seed + 7919 * n)
    q, r = np.linalg.qr(rng.standard_normal((n, n)))
    return q * np.sign(np.diag(r))[None, :]  # deterministic sign convention


@lru_cache(maxsize=None)
def odd_factor_matrix(m: int, seed: int = 0) -> np.ndarray:
    """Orthogonal (normalized) m×m factor for the odd part of a dimension:
    Paley-I Hadamard when m-1 is a prime ≡ 3 (mod 4), else seeded random
    orthogonal."""
    if m == 1:
        return np.ones((1, 1))
    if _is_prime(m - 1) and (m - 1) % 4 == 3:
        return _paley1(m - 1) / np.sqrt(m)
    return random_orthogonal(m, seed)


@lru_cache(maxsize=None)
def hadamard_matrix(n: int, seed: int = 0) -> np.ndarray:
    """Orthogonal (normalized) rotation matrix of size n ≤ 8192,
    materialized (float64 numpy)."""
    if n > 8192:
        raise ValueError(f"materializing a {n}-wide rotation; use apply_rotation")
    m, p2 = _split_pow2(n)
    if m == 1:
        return _sylvester(n) / np.sqrt(n)
    qm = odd_factor_matrix(m, seed)
    h2 = _sylvester(p2) / np.sqrt(p2) if p2 > 1 else np.ones((1, 1))
    return np.kron(qm, h2)


def fwht(x: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Fast Walsh-Hadamard transform over the last axis (power-of-two
    width), in the reference's butterfly order."""
    d = x.shape[-1]
    if not _is_pow2(d):
        raise ValueError(f"fwht needs a power-of-two width, got {d}")
    orig_shape = x.shape
    h = 1
    y = x.reshape(-1, d)
    while h < d:
        y = y.reshape(-1, d // (2 * h), 2, h)
        a = y[..., 0, :]
        b = y[..., 1, :]
        y = torch.stack([a + b, a - b], dim=-2)
        h *= 2
    y = y.reshape(orig_shape)
    if normalize:
        y = y / torch.sqrt(torch.tensor(d, dtype=x.dtype, device=x.device))
    return y


def apply_rotation(x: torch.Tensor, n: int, seed: int = 0) -> torch.Tensor:
    """y = x @ R with R = hadamard_matrix(n), applied fast in f32.
    x: (..., n)."""
    m, p2 = _split_pow2(n)
    orig_dtype = x.dtype
    x = x.to(torch.float32)
    if m == 1:
        return fwht(x).to(orig_dtype)  # H symmetric => x @ H == fwht(x)
    xr = x.reshape(*x.shape[:-1], m, p2)  # index i = a * p2 + b
    if p2 > 1:
        xr = fwht(xr)
    qm = torch.as_tensor(odd_factor_matrix(m, seed), dtype=torch.float32,
                         device=x.device)
    y = torch.einsum("...ab,ac->...cb", xr, qm)
    return y.reshape(x.shape).to(orig_dtype)
