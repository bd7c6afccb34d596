"""Calibration sequences (counterpart of ``calib_sequences`` in
``repro/data/loader.py``): the paper's 128 × 2048-token recipe, scaled."""

from __future__ import annotations

import torch

from repro_torch.data.tokens import SyntheticCorpus
from repro_torch.device import resolve_device

CORPUS_SEED = 0  # ONE corpus; `seed` below selects a disjoint sequence stream


def calib_sequences(cfg, n_seq: int = 32, seq_len: int = 256, seed: int = 1,
                    device="cuda") -> torch.Tensor:
    """Calibration token matrix (n_seq, seq_len) int32 on ``device``, bitwise
    the reference's for the same arguments."""
    corpus = SyntheticCorpus(cfg.vocab_size, seed=CORPUS_SEED)
    toks = corpus.batch(900_000_000 + seed * 1_000_003, n_seq, seq_len)
    return torch.from_numpy(toks).to(resolve_device(device))
