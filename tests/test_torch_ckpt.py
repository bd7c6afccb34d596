"""The port's checkpoint path (``repro_torch/checkpoint/ckpt.py``): the
reference's layout (``step_%08d`` directories with a manifest whose leaf
names are the reference's pytree paths, an atomic ``.tmp``-rename, keep-k
rotation, crash-debris hygiene, ``CheckpointError`` for an incomplete
checkpoint and a step-by-step fallback), with leaves written by
``torch.save`` and read back with ``weights_only=True``, so a bf16 leaf
round-trips bitwise."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jax_ckpt
from repro_torch.checkpoint import (CheckpointError, CheckpointManager,
                                    latest_step, load_checkpoint, load_leaf,
                                    save_checkpoint)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"state": {"pool": {"k": torch.randn(2, 3, 4, generator=g),
                               "v": torch.randn(2, 3, 4, generator=g).to(torch.bfloat16),
                               "codes": torch.randint(-128, 127, (2, 3), generator=g,
                                                      dtype=torch.int8)},
                      "lengths": np.arange(4, dtype=np.int32)},
            "list": [torch.tensor([1.5]), np.zeros((2, 2), np.uint8)],
            "meta": np.frombuffer(b'{"a": 1}', np.uint8)}


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)


def test_roundtrip_bitwise_with_the_reference_layout(tmp_path):
    tree = _tree()
    path = save_checkpoint(tmp_path, 7, tree)
    assert os.path.basename(path) == "step_00000007"
    assert _equal(load_checkpoint(path, tree), tree)
    # bf16 bitwise: the raw bits, not a float32 detour
    back = load_checkpoint(path, tree)["state"]["pool"]["v"]
    assert torch.equal(back.view(torch.int16), tree["state"]["pool"]["v"].view(torch.int16))
    manifest = json.loads((tmp_path / "step_00000007" / "manifest.json").read_text())
    assert manifest["step"] == 7
    # leaf names are the reference's pytree paths for the same tree
    jtree = {"state": {"pool": {k: jnp.zeros(1) for k in tree["state"]["pool"]},
                       "lengths": jnp.zeros(1)},
             "list": [jnp.zeros(1), jnp.zeros(1)], "meta": jnp.zeros(1)}
    want, _, _ = jax_ckpt._flatten_with_names(jtree)
    assert sorted(e["name"] for e in manifest["leaves"]) == sorted(want)
    assert {e["name"]: e["dtype"] for e in manifest["leaves"]}["state__pool__v"] == "bfloat16"
    assert torch.equal(load_leaf(path, "meta"), torch.from_numpy(tree["meta"].copy()))
    assert not list(tmp_path.glob(".tmp_step_*"))


def test_load_checks_names_and_shapes(tmp_path):
    tree = _tree()
    path = save_checkpoint(tmp_path, 1, tree)
    extra = dict(tree, more=torch.zeros(1))
    with pytest.raises(CheckpointError, match="missing leaf 'more'"):
        load_checkpoint(path, extra)
    with pytest.raises(CheckpointError, match="no leaf 'nope'"):
        load_leaf(path, "nope")
    wrong = dict(tree, meta=np.zeros(3, np.uint8))
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, wrong)
    # entries the like-tree does not name are ignored
    assert _equal(load_checkpoint(path, {"meta": tree["meta"]}), {"meta": tree["meta"]})


def test_keep_k_rotation_and_debris(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    (tmp_path / "step_garbage").mkdir(parents=True)
    (tmp_path / "notes.txt").write_text("stray")
    (tmp_path / ".tmp_step_00000099").mkdir()  # a mid-save crash's debris
    for step in (2, 4, 6):
        mgr.save(step, {"x": torch.tensor([step])})
    assert sorted(p.name for p in tmp_path.iterdir() if p.name.startswith("step_0")) == \
        ["step_00000004", "step_00000006"]
    assert not (tmp_path / ".tmp_step_00000099").exists()
    assert (tmp_path / "step_garbage").exists() and (tmp_path / "notes.txt").exists()
    assert latest_step(tmp_path) == 6
    assert latest_step(tmp_path / "none") is None
    step, tree = mgr.restore_latest({"x": torch.zeros(1, dtype=torch.int64)})
    assert step == 6 and int(tree["x"]) == 6


@pytest.mark.parametrize("damage", ["manifest", "leaf", "torn_leaf", "bad_manifest"])
def test_restore_latest_falls_back(tmp_path, damage):
    mgr = CheckpointManager(tmp_path, keep=3)
    like = {"x": torch.zeros(2)}
    for step in (1, 2, 3):
        mgr.save(step, {"x": torch.full((2,), float(step))})
    newest = tmp_path / "step_00000003"
    if damage == "manifest":
        (newest / "manifest.json").unlink()
    elif damage == "bad_manifest":
        (newest / "manifest.json").write_text("{not json")
    elif damage == "leaf":
        (newest / "00000.pt").unlink()
    else:
        (newest / "00000.pt").write_bytes((newest / "00000.pt").read_bytes()[:40])
    with pytest.warns(UserWarning, match="falling back to step 2"):
        step, tree = mgr.restore_latest(like)
    assert step == 2 and torch.equal(tree["x"], torch.full((2,), 2.0))
    with pytest.raises(CheckpointError):
        load_checkpoint(newest, like)


def test_every_step_damaged_or_none(tmp_path):
    mgr = CheckpointManager(tmp_path)
    assert mgr.restore_latest({"x": torch.zeros(1)}) == (None, None)
    mgr.save(1, {"x": torch.zeros(1)})
    (tmp_path / "step_00000001" / "00000.pt").write_bytes(b"")
    with pytest.warns(UserWarning, match="no older checkpoint"):
        with pytest.raises(CheckpointError, match="no restorable checkpoint"):
            mgr.restore_latest({"x": torch.zeros(1)})


def test_a_non_tensor_file_is_damage(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"x": torch.zeros(1)})
    torch.save({"not": "a tensor"}, tmp_path / "step_00000001" / "00000.pt")
    with pytest.raises(CheckpointError, match="not a tensor"):
        load_checkpoint(tmp_path / "step_00000001", {"x": torch.zeros(1)})
