"""Token batches and calibration sequences (counterpart of
``repro/data/loader.py`` for the dense and moe families): the paper's 128 ×
2048-token calibration recipe, scaled, and the step-indexed batch stream
the trainer and the benchmarks read."""

from __future__ import annotations

import torch

from repro_torch.data.tokens import SyntheticCorpus
from repro_torch.device import resolve_device

CORPUS_SEED = 0  # ONE corpus; `seed` below selects a disjoint sequence stream


def batches(cfg, global_batch: int, seq_len: int, seed: int = 0,
            start_step: int = 0, device="cuda"):
    """Infinite iterator of ``(step, {"tokens": (global_batch, seq_len)
    int32})`` on ``device``, step-indexed for exact replay; ``seed`` picks
    a disjoint sequence stream of the same corpus.  The tokens are bitwise
    the reference's for the same arguments, for both families: a dense
    and a moe batch are the same tokens.  The reference's encdec frames and
    vlm patches belong to families the port does not have yet, which
    raise."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"batches for family {cfg.family!r} are not "
                                  f"ported; only 'dense' and 'moe'")
    dev = resolve_device(device)
    corpus = SyntheticCorpus(cfg.vocab_size, seed=CORPUS_SEED)
    step = start_step
    stream = seed * 1_000_003
    while True:
        toks = corpus.batch(stream + step * global_batch, global_batch, seq_len)
        yield step, {"tokens": torch.from_numpy(toks).to(dev)}
        step += 1


def calib_sequences(cfg, n_seq: int = 32, seq_len: int = 256, seed: int = 1,
                    device="cuda") -> torch.Tensor:
    """Calibration token matrix (n_seq, seq_len) int32 on ``device``, bitwise
    the reference's for the same arguments."""
    corpus = SyntheticCorpus(cfg.vocab_size, seed=CORPUS_SEED)
    toks = corpus.batch(900_000_000 + seed * 1_000_003, n_seq, seq_len)
    return torch.from_numpy(toks).to(resolve_device(device))
