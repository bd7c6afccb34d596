"""Which weights get W4A4 + LRC treatment, and at what rank (counterpart
of ``repro/quant/policy.py``; the fields the port uses).

``rank_frac`` — the paper's headline knob: low-rank size as a fraction of
min(d_in, d_out).  ``act_group`` — the activation scale group (paper
Table 2: 128; None = per-token), with per-layer ``act_group_overrides``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    bits: int = 4
    act_bits: int = 4
    act_group: Optional[int] = None  # paper Table 2: 128
    # Per-layer activation-group overrides keyed by layer name (the
    # calibration walker's tags, e.g. "mlp/wd"): None forces a layer back
    # to per-token while act_group covers the rest; an int sets that
    # layer's own group.  Stored as a sorted tuple of (name, group) pairs so
    # the frozen policy stays hashable.
    act_group_overrides: tuple = ()
    rank_frac: float = 0.10  # 0.0 disables the low-rank correction
    clip_ratio: float = 0.9
    impl: str = "int8"
    lrc_iters: int = 1
    quant_method: str = "gptq"  # gptq | rtn
    correction: str = "lrc"  # lrc | svd | none

    def __post_init__(self):
        ovr = self.act_group_overrides
        # any accepted spelling (a dict, or (name, group) pairs as tuples or
        # lists) becomes one sorted tuple, so equal policies compare equal
        if isinstance(ovr, dict):
            ovr = ovr.items()
        ovr = tuple(tuple(e) if isinstance(e, (tuple, list)) else e for e in ovr)
        for entry in ovr:
            if (not isinstance(entry, tuple) or len(entry) != 2
                    or not isinstance(entry[0], str)
                    or isinstance(entry[1], bool)  # True would be group 1
                    or not (entry[1] is None
                            or (isinstance(entry[1], int) and entry[1] > 0))):
                raise ValueError(
                    f"act_group_overrides entries must map a layer-name string to "
                    f"a positive int group (or None = per-token), got {entry!r}")
        object.__setattr__(self, "act_group_overrides",
                           tuple(sorted(ovr, key=lambda e: e[0])))

    def act_group_for(self, name: Optional[str]) -> Optional[int]:
        """The activation scale group of one layer: the override whose key
        is ``name`` or a "/"-delimited suffix of it ("mlp/wd" matches
        "layers/mlp/wd"), else the policy-wide ``act_group``."""
        if name is not None:
            for key, group in self.act_group_overrides:
                if name == key or name.endswith("/" + key):
                    return group
        return self.act_group

    def rank(self, d_in: int, d_out: int) -> int:
        if self.rank_frac <= 0:
            return 0
        return max(1, int(round(self.rank_frac * min(d_in, d_out))))
