"""Fault-tolerant checkpointing (counterpart of ``repro/checkpoint/ckpt.py``).

- One file per leaf, written with ``torch.save`` and read back with
  ``torch.load(..., weights_only=True)`` to the host, then moved to the
  caller's device (numpy has no bf16, and a bf16 pool must round-trip
  bitwise), plus a JSON manifest of
  the leaves' names, shapes and dtypes.  A numpy leaf is stored as a tensor
  and comes back as numpy where the ``like`` tree holds numpy.
- ATOMIC: written to ``<dir>/.tmp_step_*`` then ``os.rename``'d, so a crash
  mid-save never corrupts the latest checkpoint.
- keep-k rotation, with crash-debris hygiene: stray non-``step_*`` entries
  and malformed ``step_<garbage>`` names never break the scan, and orphaned
  ``.tmp_step_*`` directories left by a mid-save crash are removed on the
  next rotation.
- An incomplete checkpoint (missing manifest, missing or unreadable leaf
  file, manifest missing an expected leaf) raises :class:`CheckpointError`;
  ``CheckpointManager.restore_latest`` falls back step by step to the newest
  checkpoint that loads cleanly.

A tree is made of dicts, lists and dataclasses (the trainer's
``TrainState`` and ``AdamWState``, ``QLinear``), a dataclass's leaves named
by its field names as the reference's registered dataclasses are.  As in a
JAX pytree, None is an empty subtree (a QLinear without a low-rank term
stores no ``u``/``v``), and a dataclass field marked ``metadata={"static":
True}`` (QLinear's bits, groups, impl, name and kernel context: the
reference's aux data) is no leaf: it is not stored, and a load takes it
from the ``like`` tree.  The trainer saves
every N steps through ``CheckpointManager.maybe_save``; the serving
engine's snapshots (``ServeEngine.snapshot`` / ``restore``) ride on the
same path on a schedule of their own.  The reference's ``shardings``
(mesh-elastic restore) waits for the port's distributed serving.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


class CheckpointError(RuntimeError):
    """A checkpoint directory exists but cannot be loaded (missing
    manifest, missing or unreadable leaf file, manifest missing an expected
    leaf): typically debris from a crash mid-save that slipped past the
    atomic rename."""


def _flatten_with_names(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(name, leaf) pairs of a tree of dicts, lists and dataclasses, names
    joined by ``__`` as the reference's pytree paths are."""
    if tree is None:
        return []
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [pair for f in _array_fields(tree)
                for pair in _flatten_with_names(getattr(tree, f.name),
                                                prefix + (f.name,))]
    if isinstance(tree, dict):
        return [pair for k, v in tree.items()
                for pair in _flatten_with_names(v, prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in _flatten_with_names(v, prefix + (str(i),))]
    return [("__".join(prefix) or "leaf", tree)]


def _array_fields(obj):
    """A dataclass's fields that hold its leaves (not its static ones)."""
    return [f for f in dataclasses.fields(obj) if not f.metadata.get("static")]


def _unflatten_like(like, leaves):
    """A tree shaped as ``like`` whose leaves are taken in order from the
    iterator ``leaves`` (None subtrees and static fields as in ``like``)."""
    if like is None:
        return None
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return dataclasses.replace(like, **{
            f.name: _unflatten_like(getattr(like, f.name), leaves)
            for f in _array_fields(like)})
    if isinstance(like, dict):
        return {k: _unflatten_like(v, leaves) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten_like(v, leaves) for v in like)
    return next(leaves)


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    return torch.from_numpy(np.array(leaf))  # a copy: the leaf may be read-only


def _step_dirs(ckpt_dir) -> Dict[int, Path]:
    """Map step -> checkpoint dir, skipping crash debris: non-``step_*``
    entries, ``step_<non-integer>`` strays, and plain files."""
    d = Path(ckpt_dir)
    if not d.exists():
        return {}
    out: Dict[int, Path] = {}
    for p in d.iterdir():
        if not p.is_dir() or not p.name.startswith("step_"):
            continue
        try:
            step = int(p.name.split("_", 1)[1])
        except ValueError:
            continue  # "step_garbage" debris: never a checkpoint we wrote
        out[step] = p
    return out


def _gc_orphan_tmp(ckpt_dir) -> int:
    """Remove orphaned ``.tmp_step_*`` directories (a crash mid-save left
    them behind; the atomic rename means they are never the latest state).
    Returns the number removed."""
    d = Path(ckpt_dir)
    if not d.exists():
        return 0
    n = 0
    for p in d.iterdir():
        if p.is_dir() and p.name.startswith(".tmp_step_"):
            shutil.rmtree(p, ignore_errors=True)
            n += 1
    return n


def save_checkpoint(ckpt_dir, step: int, tree: Any) -> str:
    """Atomic save of a tree of tensors / numpy arrays at
    ``<ckpt_dir>/step_<step>``."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "leaves": []}
    for i, (name, leaf) in enumerate(_flatten_with_names(tree)):
        t = _as_tensor(leaf)
        fname = f"{i:05d}.pt"
        torch.save(t, tmp / fname)
        manifest["leaves"].append(dict(name=name, file=fname,
                                       shape=list(t.shape),
                                       dtype=str(t.dtype).replace("torch.", "")))
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return str(final)


def _read_manifest(path: Path) -> dict:
    mf = path / "manifest.json"
    if not mf.exists():
        raise CheckpointError(
            f"checkpoint {path} is incomplete: no manifest.json "
            f"(crash debris?)")
    try:
        return json.loads(mf.read_text())
    except (json.JSONDecodeError, OSError) as e:
        raise CheckpointError(
            f"checkpoint {path} has an unreadable manifest: {e}") from None


def _load_file(path: Path, entry: dict) -> torch.Tensor:
    """One leaf file as a host tensor.  Any file ``torch.load`` cannot read
    (missing, truncated, not a tensor) is a :class:`CheckpointError`; the
    callers move the tensor to the device outside this guard, so a device
    error is never taken for a damaged checkpoint."""
    try:
        t = torch.load(path / entry["file"], weights_only=True,
                       map_location="cpu")
    except Exception as e:
        # a host read: a damaged file surfaces as whatever the unpickler
        # trips on (UnpicklingError, EOFError, IndexError, RuntimeError...)
        raise CheckpointError(
            f"checkpoint {path} leaf {entry['name']!r} is unreadable: "
            f"{type(e).__name__}: {e}") from None
    if not isinstance(t, torch.Tensor):
        raise CheckpointError(
            f"checkpoint {path} leaf {entry['name']!r} holds a "
            f"{type(t).__name__}, not a tensor")
    return t


def load_leaf(path, name: str) -> torch.Tensor:
    """Load ONE named leaf from a checkpoint without rebuilding the whole
    tree (for variable-shape leaves the ``like`` protocol cannot express,
    e.g. the serving snapshot's JSON blob), as a host tensor."""
    path = Path(path)
    manifest = _read_manifest(path)
    for entry in manifest["leaves"]:
        if entry["name"] == name:
            return _load_file(path, entry)
    raise CheckpointError(
        f"checkpoint {path} is incomplete: manifest has no leaf {name!r}")


def load_checkpoint(path, like: Any, device="cpu") -> Any:
    """Restore a tree saved by :func:`save_checkpoint` into the structure of
    ``like`` (tensors or numpy arrays): tensor leaves come back as tensors
    on ``device``, numpy leaves as numpy arrays.

    Manifest entries not named by ``like`` are ignored; a leaf ``like``
    expects but the manifest lacks raises :class:`CheckpointError` (the
    "checkpoint incomplete" signal ``restore_latest`` falls back on); a leaf
    of another shape raises ``ValueError``."""
    path = Path(path)
    manifest = _read_manifest(path)
    by_name = {e["name"]: e for e in manifest["leaves"]}
    out = []
    for name, like_leaf in _flatten_with_names(like):
        entry = by_name.get(name)
        if entry is None:
            raise CheckpointError(
                f"checkpoint {path} is incomplete: manifest is missing "
                f"leaf {name!r} ({len(by_name)} leaves present)")
        t = _load_file(path, entry)
        expect = tuple(like_leaf.shape)
        if tuple(t.shape) != expect:
            raise ValueError(f"{name}: checkpoint shape {tuple(t.shape)} != {expect}")
        out.append(t.to(device) if isinstance(like_leaf, torch.Tensor) else t.numpy())
    return _unflatten_like(like, iter(out))


def latest_step(ckpt_dir) -> Optional[int]:
    steps = sorted(_step_dirs(ckpt_dir))
    return steps[-1] if steps else None


class CheckpointManager:
    """save-every-N + keep-k rotation + resume-from-latest (with fallback
    past incomplete checkpoints and crash-debris garbage collection)."""

    def __init__(self, ckpt_dir, every: int = 100, keep: int = 3):
        self.dir = Path(ckpt_dir)
        self.every = every
        self.keep = keep

    def maybe_save(self, step: int, tree) -> Optional[str]:
        """:meth:`save` at every ``every``-th step, else nothing (None)."""
        if step % self.every != 0:
            return None
        return self.save(step, tree)

    def save(self, step: int, tree) -> str:
        """Unconditional atomic save + rotation (``maybe_save`` without the
        every-N gate: the serving engine snapshots on its own schedule)."""
        path = save_checkpoint(self.dir, step, tree)
        self._gc()
        return path

    def _gc(self):
        _gc_orphan_tmp(self.dir)
        by_step = _step_dirs(self.dir)
        for s in sorted(by_step)[: -self.keep]:
            shutil.rmtree(by_step[s], ignore_errors=True)

    def restore_latest(self, like, device="cpu"):
        """Load the newest checkpoint that restores cleanly.  An incomplete
        checkpoint (``CheckpointError``) is skipped with a warning naming
        the fallback step; if every candidate is damaged the last error is
        re-raised.  No checkpoints at all -> ``(None, None)``."""
        by_step = _step_dirs(self.dir)
        last_err: Optional[CheckpointError] = None
        for step in sorted(by_step, reverse=True):
            try:
                return step, load_checkpoint(by_step[step], like, device)
            except CheckpointError as e:
                older = [s for s in by_step if s < step]
                fallback = (f"falling back to step {max(older)}" if older
                            else "no older checkpoint to fall back to")
                warnings.warn(f"checkpoint incomplete at step {step} "
                              f"({e}); {fallback}")
                last_err = e
        if last_err is not None:
            raise CheckpointError(
                f"no restorable checkpoint under {self.dir}: every step in "
                f"{sorted(by_step)} is incomplete ({last_err})")
        return None, None
