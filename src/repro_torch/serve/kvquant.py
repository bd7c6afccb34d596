"""KV-cache quantization: the ``KVSpec`` axis of the cache layout
(counterpart of ``repro/serve/kvquant.py``).

A :class:`KVSpec` sets the storage width of the paged KV pool:

* ``dtype`` ∈ {``f32``, ``bf16``, ``int8``, ``int4``}.  ``int4`` packs two
  values per byte along ``head_dim`` (the ``core.quantizers.pack_int4``
  nibble layout: the low nibble is the even element).
* ``group`` — scale granularity along ``head_dim``: ``None`` = one scale
  per (token, kv-head), or an integer ``g`` giving ``head_dim // g`` scales
  per head.  ``g`` is clamped to ``head_dim`` at use, so ``group=128`` on a
  96-wide head is per-head.

Quantized pools carry an f32 scale-plane sidecar, leaves ``k_scale`` /
``v_scale`` shaped ``(L, num_pages, page_size, n_kv_heads, n_groups)``,
indexed by the same page ids as the data pool (``PageAllocator(...,
sidecar=True)`` keeps the two accountings in lockstep).

:func:`quantize_kv` and :func:`dequantize_kv` are the one spelling every
consumer shares: the gather route of ``models/common.py``, the plain
version of the paged attention kernel (``kernels/flash_attn.py``), and the
CUDA kernel, which dequantizes with the same single f32 multiply per
element.  They are bitwise the reference's on the CPU.

The ``f32`` spec is the identity: no scale leaves, the pool code paths of
the float cache.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.quantizers import pack_int4, unpack_int4
from repro_torch.kernels.rowops import amax_to_scale, dequant_rows_grouped

KV_DTYPES = ("f32", "bf16", "int8", "int4")
_FLOAT_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
_BITS = {"int8": 8, "int4": 4}


@dataclasses.dataclass(frozen=True)
class KVSpec:
    """Static description of the KV-cache storage scheme (frozen and
    hashable, like ``KernelContext``)."""

    dtype: str = "f32"
    # scale group along head_dim (quantized dtypes only); None = per-head
    group: Optional[int] = None

    def __post_init__(self):
        if self.dtype not in KV_DTYPES:
            raise ValueError(
                f"unknown kv dtype {self.dtype!r}; one of {KV_DTYPES}")
        if self.group is not None:
            if not self.is_quantized:
                raise ValueError(
                    f"kv group={self.group} only applies to quantized kv "
                    f"dtypes, not {self.dtype!r}")
            if not (isinstance(self.group, int) and self.group > 0):
                raise ValueError(f"kv group must be a positive int, "
                                 f"got {self.group!r}")

    # -- classification ------------------------------------------------------

    @property
    def is_quantized(self) -> bool:
        return self.dtype in _BITS

    @property
    def bits(self) -> int:
        return _BITS[self.dtype]

    @property
    def qmax(self) -> int:
        return 2 ** (self.bits - 1) - 1

    @property
    def cache_dtype(self) -> torch.dtype:
        """Storage dtype of a FLOAT spec's pool (f32 / bf16)."""
        if self.is_quantized:
            raise ValueError(
                f"kv dtype {self.dtype!r} has no float cache dtype; "
                f"quantized specs only apply to the paged pool")
        return _FLOAT_DTYPES[self.dtype]

    @property
    def pool_dtype(self) -> torch.dtype:
        """Element dtype of the paged K/V pool leaves."""
        if self.dtype == "int8":
            return torch.int8
        if self.dtype == "int4":
            return torch.uint8  # two nibbles per byte, pack_int4 layout
        return _FLOAT_DTYPES[self.dtype]

    # -- geometry ------------------------------------------------------------

    def group_for(self, head_dim: int) -> int:
        """Effective scale group: ``min(group, head_dim)`` (``group=None``
        → ``head_dim``, i.e. per-head).  Must divide ``head_dim``."""
        g = head_dim if self.group is None else min(self.group, head_dim)
        if head_dim % g != 0:
            raise ValueError(
                f"kv group {self.group} does not divide head_dim "
                f"{head_dim} (effective group {g})")
        return g

    def n_groups(self, head_dim: int) -> int:
        """Scales per (token, kv-head); 0 for float specs (no sidecar)."""
        if not self.is_quantized:
            return 0
        return head_dim // self.group_for(head_dim)

    def packed_head_dim(self, head_dim: int) -> int:
        """Last-axis width of a pool leaf (int4 packs two per byte)."""
        if self.dtype == "int4":
            if head_dim % 2 != 0:
                raise ValueError(f"int4 kv needs an even head_dim, "
                                 f"got {head_dim}")
            return head_dim // 2
        return head_dim

    def kv_bytes_per_token(self, n_kv_heads: int, head_dim: int) -> int:
        """Device bytes ONE token's K+V occupy in one layer (data + scale
        planes)."""
        if self.dtype == "f32":
            per_head = 4 * head_dim
        elif self.dtype == "bf16":
            per_head = 2 * head_dim
        else:
            per_head = self.packed_head_dim(head_dim) \
                + 4 * self.n_groups(head_dim)
        return 2 * n_kv_heads * per_head  # K and V

    # -- serialization -------------------------------------------------------

    @classmethod
    def from_flags(cls, dtype: Optional[str], group: Optional[int]) -> "KVSpec":
        """Build from ``--kv-dtype`` / ``--kv-group`` (None → defaults)."""
        return cls(dtype=dtype or "f32", group=group)

    def to_meta(self) -> dict:
        return {"kv_dtype": self.dtype, "kv_group": self.group}

    @classmethod
    def from_meta(cls, meta: dict) -> "KVSpec":
        """Read a spec out of a meta dict; one without the keys is f32."""
        return cls(dtype=meta.get("kv_dtype", "f32"),
                   group=meta.get("kv_group"))

    def describe(self) -> str:
        if not self.is_quantized or self.group is None:
            return self.dtype
        return f"{self.dtype}-g{self.group}"


# ---------------------------------------------------------------------------
# the quantize / dequantize spellings
# ---------------------------------------------------------------------------


def quantize_kv(x: torch.Tensor, spec: KVSpec):
    """Quantize KV rows ``x (..., head_dim)`` → ``(q, scales)``.

    Per group of ``spec.group_for(head_dim)`` features: absmax →
    ``amax_to_scale`` (zero-guarded, clip ratio 1) → ``clip(round(x/s))``.
    ``q`` is int8 (or pack_int4'd uint8, two per byte along head_dim);
    ``scales`` is f32 ``(..., n_groups)``.  A row quantizes to the same
    bytes wherever it lands, so outputs stay invariant to page placement."""
    hd = x.shape[-1]
    g = spec.group_for(hd)
    xg = x.to(torch.float32).reshape(*x.shape[:-1], hd // g, g)
    s = amax_to_scale(xg.abs().amax(dim=-1), spec.qmax, 1.0)
    q = torch.clamp(torch.round(xg / s[..., None]), -spec.qmax - 1, spec.qmax) \
        .to(torch.int8).reshape(*x.shape[:-1], hd)
    if spec.dtype == "int4":
        q = pack_int4(q)
    return q, s


def dequantize_kv(q: torch.Tensor, scales: torch.Tensor, spec: KVSpec,
                  head_dim: int) -> torch.Tensor:
    """(unpack →) group reshape → ONE f32 multiply by the scale plane →
    f32 ``(..., head_dim)``."""
    if spec.dtype == "int4":
        q = unpack_int4(q)
    g = spec.group_for(head_dim)
    lead = q.shape[:-1]
    x = dequant_rows_grouped(q.reshape(-1, head_dim),
                             scales.reshape(-1, head_dim // g), g)
    return x.reshape(*lead, head_dim)
