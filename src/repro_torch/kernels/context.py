"""Per-layer kernel execution config: :class:`KernelContext` (the part of
``repro/kernels/context.py`` the port needs).

Three kernel paths serve a W4A4+LRC linear, strongest fusion first:

  fused   — ONE kernel (``fused_gemm.py``): quantize, x·V, int4 GEMM and
            epilogue; xq never reaches device memory.
  chained — TWO kernels: ``prologue.py`` (xq, sx, xv) → ``w4a4.py``.
  unfused — ``actquant.py`` (xq, sx), x·V in plain torch, then the same
            GEMM kernel.

The reference picks tiles and demotes a path when its VMEM working set does
not fit.  Here the tiles are constants of the CUDA sources, so a plan is a
path only.  ``"auto"`` takes the fused path unless the fused path's
admission rule refuses the site: its bytes (``fused_gemm.admission_bytes(K,
R, act_group)``, which grow with K and, group-wise, with the K/g scale
plane) above ``fused_gemm.SMEM_LIMIT``, or R above ``fused_gemm.MAX_RANK``;
it then demotes to chained, which any K and any group that divides K fit.
The rule is the first fused kernel's shared memory, kept so that the
served routes do not move with the kernel's design (SmolLM-135M's sites
fused, Phi-3-mini's and Gemma-7b's chained); the kernel itself fits
wherever the rule admits.  A group that does not divide K raises, as in
the reference.
The decision is made from shapes alone, before anything is built or
launched, and ``ServeEngine.health()`` reports it.  An explicit impl is
trusted: the wrapper raises if it cannot run it.

Per-layer overrides are keyed by layer name (``"mlp/wd"``), by the (K, N,
R) triple or by its ``"KxNrR"`` spelling, and carry ``path`` only; the
reference's tile keys raise ``NotImplementedError``.

``attention`` picks the route of three attentions (``kernels/flash_attn.py``
holds the kernels):

  * a decode step's (S = 1) in ``models/transformer.paged_step``:
    ``"kernel"`` — the paged attention kernels, which read the pool in
    place; ``"gather"`` — the reference's route, every row's pages gathered
    into a dense view and :func:`~repro_torch.models.common.attention`;
  * a prefill step's (an engine prefill chunk of any width, or a full
    sequence) in the same ``paged_step``: ``"kernel"`` — each row's pages gathered as codes and
    scale planes (or float rows), no dequant, into the dense flash kernels
    with the row's query offset (the quantized one for an int8 / int4
    pool); ``"gather"`` — the reference's route as for decode.  Every chunk
    of a prompt takes the same route, so a token's K/V, and the greedy
    stream, do not depend on the chunk width;
  * the dense causal attention of the cache-free ``transformer.forward``
    and of the calibration walk (``quant/calibrate.py``), whose mask is the
    aligned causal one (query and key positions both from 0): ``"kernel"``
    — the flash-attention kernel; ``"gather"`` — the reference's
    :func:`~repro_torch.models.common.attention` under ``causal_mask``;
  * the contiguous-cache ``transformer.prefill`` and ``decode_step``
    (causal from the cache's offset): the flash-attention kernel with that
    ``q_start``, or the reference's masks.
    A prefix-LM mask (``forward`` / ``prefill`` with ``prefix_len`` or
    ``embeds``) keeps ``attention``: the kernel does not compute it, and
    ``attention="kernel"`` raises for it.

``"auto"`` takes the kernel route when the tensors are on a CUDA device,
and the reference's route on the CPU (where it keeps the reference's
numerics, as QLinear keeps its calibrated impl there).  The dense flash
kernels (prefill, forward, walk) take head dims up to ``flash_attn.MAX_D``
= 256 (so Gemma's and PaliGemma's 256 take the kernel route):
"auto" demotes a wider head's dense attention to gather from shapes alone,
before anything is built or launched, as :meth:`KernelContext.resolve_plan`
demotes a W4A4 site (:meth:`KernelContext.attention_plan` says why;
``ServeEngine.health()`` reports it).  The paged decode kernels have no such
limit, so decode keeps the kernel route at any head dim.  An explicit route
is run as asked on either device: on the CPU the kernel route runs the
kernels' plain versions, and on the card a head dim the kernels cannot take
raises in their wrappers.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import flash_attn, fused_gemm
from repro_torch.kernels.rowops import check_group

KERNEL_PATHS = ("fused", "chained", "unfused")
IMPLS = ("auto",) + KERNEL_PATHS
ATTENTION_ROUTES = ("auto", "kernel", "gather")
# why a prefix-LM mask (bidirectional over a prefix, causal after it) keeps
# the gather route
PREFIX_LM_REASON = ("a prefix-LM mask is not causal, and the flash attention "
                    "kernel (#7) has no prefix argument")
_TILE_KEYS = ("bm", "bn", "bk", "br", "variant")


class AttentionPlan(NamedTuple):
    """A resolved attention route, ``"kernel"`` or ``"gather"``, and why
    "auto" demoted a CUDA device's kernel route to gather (None when it did
    not)."""
    route: str
    demoted: Optional[str]


class Plan(NamedTuple):
    """A resolved plan: the kernel path, whether the caller chose it (an
    explicit impl, a non-auto context or a layer override), and whether a
    fused path was demoted because the site does not fit it."""
    path: str
    pinned: bool
    demoted: bool


def _override_key(key):
    if isinstance(key, (tuple, list)):
        if len(key) != 3 or not all(isinstance(d, int) for d in key):
            raise ValueError(f"a shape override key must be (K, N, R), got {key!r}")
        return tuple(key)
    if not isinstance(key, str):
        raise ValueError(f"an override key must be a layer name, (K, N, R) "
                         f"or 'KxNrR'; got {key!r}")
    return key


def _check_entry(key, entry) -> None:
    if not isinstance(entry, dict):
        raise ValueError(f"override for {key!r} must be a dict, got {entry!r}")
    tiles = sorted(set(entry) & set(_TILE_KEYS))
    if tiles:
        raise NotImplementedError(
            f"override for {key!r} sets {tiles}: the port's tiles are "
            f"constants of its CUDA sources; an override carries 'path' only")
    unknown = sorted(set(entry) - {"path"})
    if unknown:
        raise ValueError(f"unknown override keys {unknown} for {key!r}")
    if entry.get("path") not in KERNEL_PATHS:
        raise ValueError(f"override for {key!r} needs a path in "
                         f"{KERNEL_PATHS}, got {entry.get('path')!r}")


@dataclasses.dataclass(frozen=True)
class KernelContext:
    """An immutable kernel config: the default impl, the per-layer path
    overrides, ``((key, path), ...)`` sorted by key (hashable), and the
    attention route."""

    impl: str = "auto"
    overrides: tuple = ()
    attention: str = "auto"

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise ValueError(f"unknown impl {self.impl!r}; expected one of {IMPLS}")
        if self.attention not in ATTENTION_ROUTES:
            raise ValueError(f"unknown attention route {self.attention!r}; "
                             f"expected one of {ATTENTION_ROUTES}")
        items = (self.overrides.items() if isinstance(self.overrides, dict)
                 else self.overrides)
        frozen = {}
        for key, entry in items:
            key = _override_key(key)
            entry = {"path": entry} if isinstance(entry, str) else dict(entry)
            _check_entry(key, entry)
            frozen[key] = entry["path"]
        object.__setattr__(self, "overrides", tuple(
            sorted(frozen.items(), key=lambda e: str(e[0]))))

    # -- builders (return new contexts) -------------------------------------

    def with_impl(self, impl: str) -> "KernelContext":
        return dataclasses.replace(self, impl=impl)

    def with_layer_overrides(self, overrides: dict) -> "KernelContext":
        """Merge per-layer path overrides (``{key: {"path": ...}}``) onto
        the existing ones."""
        merged = dict(self.overrides)
        for key, entry in overrides.items():
            merged[_override_key(key)] = entry
        return dataclasses.replace(self, overrides=tuple(merged.items()))

    # -- resolution ---------------------------------------------------------

    def layer_path(self, layer: Optional[str], k: int, n: int,
                   r: int = 0) -> Optional[str]:
        """The overridden path for this layer or shape, or None.  Lookup
        precedence: layer name, then (K, N, R), then "KxNrR"."""
        table = dict(self.overrides)
        for key in (layer, (k, n, r), f"{k}x{n}r{r}"):
            if key is not None and key in table:
                return table[key]
        return None

    def resolve_plan(self, m: int, k: int, n: int, r: int = 0,
                     layer: Optional[str] = None,
                     impl: Optional[str] = None, rotate: bool = False,
                     act_group: Optional[int] = None) -> Plan:
        """The path a (M, K, N, R) problem runs.  ``impl`` (None → this
        context's) other than "auto" pins the path, trusted as it is.
        Under "auto" a layer override sets the path, else fused; a fused
        path is then demoted to chained when the site does not fit it
        (``act_group``'s scale plane included), as the reference demotes a
        layer override too.  ``act_group`` must divide K (``ValueError``
        otherwise, on every path).  M does not enter the admission rule.
        ``rotate`` is accepted for the reference's signature and ignored:
        the rule does not depend on it, and the fused kernel takes every
        rotated site the rule admits."""
        if act_group is not None:
            check_group(k, act_group)
        impl = self.impl if impl is None else impl
        if impl not in IMPLS:
            raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
        if impl != "auto":
            return Plan(impl, True, False)
        path = self.layer_path(layer, k, n, r)
        pinned = path is not None
        if (path or "fused") == "fused" and not fused_gemm.fits(k, r, act_group):
            return Plan("chained", pinned, True)
        return Plan(path or "fused", pinned, False)

    def attention_plan(self, device, head_dim: int, decode: bool = False,
                       prefix: bool = False) -> AttentionPlan:
        """The route attention takes on ``device`` (where the pool or the
        activations live) for heads of ``head_dim``: a paged decode step's
        when ``decode``, else a dense one's (prefill, forward, walk).
        ``prefix``: the dense attention is under a prefix-LM mask, which
        the flash kernel (#7, like the reference's Pallas kernel) does not
        compute, so it takes the gather route, and an explicit "kernel"
        raises.  Any other explicit route is trusted as it is; under "auto"
        a CUDA device takes the kernel route, unless a dense attention's
        ``head_dim`` exceeds the flash kernels' ``MAX_D``, and the CPU the
        gather route."""
        if prefix:
            if self.attention == "kernel":
                raise ValueError(
                    f"attention='kernel': {PREFIX_LM_REASON}; prefix-LM "
                    f"attention takes the gather route")
            demoted = (self.attention == "auto"
                       and torch.device(device).type == "cuda")
            return AttentionPlan("gather", PREFIX_LM_REASON if demoted else None)
        if self.attention != "auto":
            return AttentionPlan(self.attention, None)
        if torch.device(device).type != "cuda":
            return AttentionPlan("gather", None)
        if not decode and head_dim > flash_attn.MAX_D:
            return AttentionPlan("gather",
                                 f"head_dim {head_dim} exceeds the flash "
                                 f"attention kernels' MAX_D {flash_attn.MAX_D}")
        return AttentionPlan("kernel", None)

    def attention_route(self, device, head_dim: int, decode: bool = False,
                        prefix: bool = False) -> str:
        """:meth:`attention_plan`'s route: ``"kernel"`` or ``"gather"``."""
        return self.attention_plan(device, head_dim, decode, prefix).route
