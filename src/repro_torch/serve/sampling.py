"""Token sampling (greedy / temperature / top-k) with a finite-ness guard
(counterpart of ``repro/serve/sampling.py``).

The reference draws from ``jax.random`` keys folded from (seed, rid, token
index); here the same triple seeds a ``torch.Generator``
(:func:`sampling_generator`), so a request's draws stay independent of its
slot and co-tenants.  The numbers differ from the reference's; greedy
decoding is exact.
"""

from __future__ import annotations

import numpy as np
import torch


class NonFiniteLogitsError(FloatingPointError):
    """Non-finite logits reached the sampling boundary."""


def sampling_generator(seed: int, rid: int, index: int, device) -> torch.Generator:
    """A generator that depends only on (engine seed, rid, token index)."""
    state = np.random.SeedSequence([seed, rid, index]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]) >> 1)


def sample_token(logits, generator=None, temperature: float = 0.0,
                 top_k: int = 0, check_finite: bool = False):
    """logits: (B, V) -> (B,) int32.  ``check_finite=True`` raises
    :class:`NonFiniteLogitsError` before any token is drawn from bad
    logits."""
    if check_finite and not bool(torch.isfinite(logits).all()):
        n_nan = int(torch.isnan(logits).sum())
        n_inf = int(torch.isinf(logits).sum())
        raise NonFiniteLogitsError(
            f"non-finite logits at sampling boundary: {n_nan} NaN, "
            f"{n_inf} Inf of {logits.numel()} entries")
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.to(torch.float32) / temperature
    if top_k > 0:
        cutoff = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < cutoff, torch.finfo(logits.dtype).min,
                             logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0].to(torch.int32)
