"""Which weights get W4A4 + LRC treatment, and at what rank (counterpart
of ``repro/quant/policy.py``; the fields this slice uses).

``rank_frac`` — the paper's headline knob: low-rank size as a fraction of
min(d_in, d_out).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    bits: int = 4
    act_bits: int = 4
    act_group: Optional[int] = None
    rank_frac: float = 0.10  # 0.0 disables the low-rank correction
    clip_ratio: float = 0.9
    impl: str = "int8"
    lrc_iters: int = 1
    quant_method: str = "gptq"  # gptq | rtn
    correction: str = "lrc"  # lrc | svd | none

    def rank(self, d_in: int, d_out: int) -> int:
        if self.rank_frac <= 0:
            return 0
        return max(1, int(round(self.rank_frac * min(d_in, d_out))))
