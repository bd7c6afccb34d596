"""MoE training in the port against the reference, on the reduced
DeepSeek-V2 and -V3 (2 layers: one dense-FFN, one MoE of 8 experts top-2
and a shared one; V3 with its sigmoid router and its MTP block; d_model 64,
f32), weights bridged from the JAX package's init:

* ``deepseek.forward(return_hidden=True)`` and ``mtp_logits``;
* ``model.loss_fn`` (V2: the next-token CE; V3: plus ``0.3 · CE`` of the
  MTP head's t → t+2 predictions) and every gradient leaf against
  ``jax.value_and_grad`` of the reference's loss;
* one AdamW update, whose weight decay must follow the reference's
  stacked layout (the per-layer norms of ``dense_layers`` and
  ``moe_layers`` decayed, the unstacked MTP block's norms not);
* ``data/loader.batches`` for moe, bitwise the reference's;
* ``train`` on the reduced V3 (loss falling, the resume bitwise) and the
  training launcher on the CPU;
* the absorbed MLA path on the kernel route (its causal mask from
  ``q_start``) against the gather route.

Tolerances, ``test_torch_train``'s: the loss relative 1e-6 and
every gradient leaf within 1e-5 of its largest element (the frameworks'
f32 sums in other orders; measured here <= 3e-7 and <= 2e-6); logits
within 1e-4 absolute (``test_torch_model``); one AdamW update within 1e-6
of each leaf's largest element.  A resumed run and the absorbed path's two
routes: the same operations on the same inputs, so bitwise, and 1e-5 for
the routes (the causal mask against the caller's mask of the same
shape, einsums alike: measured 0).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.loader import batches as jax_batches
from repro.models import deepseek as jax_deepseek
from repro.models import model as jax_model
from repro.train import optimizer as jopt
from repro_torch import bridge
from repro_torch.data.loader import batches
from repro_torch.kernels.context import KernelContext
from repro_torch.launch import train as train_cli
from repro_torch.models import deepseek, model
from repro_torch.train import optimizer, steps
from repro_torch.train.trainer import train
from torch_moe_parity import ARCHS, ds_configs, ds_params
from torch_parity import to_numpy_tree

LR = 1e-2


def _port(tree):
    return bridge.params_from_jax(to_numpy_tree(tree), device="cpu")


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    """The reference's loss and gradients on one batch, its forward's hidden
    states and MTP logits, and one AdamW update with those gradients."""
    jcfg, tcfg = ds_configs(request.param)
    jparams = ds_params(jcfg)
    _, jb = next(jax_batches(jcfg, 4, 16, seed=3))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_model.loss_fn(jcfg, p, b)))(jparams, jb)
    logits, hidden = jax_deepseek.forward(jcfg, jparams, jb["tokens"], return_hidden=True)
    mtp = (jax_deepseek.mtp_logits(jcfg, jparams, jb["tokens"], hidden)
           if jcfg.mtp_depth else None)
    upd = jax.jit(jopt.adamw_update)(jparams, grads, jopt.adamw_init(jparams),
                                     jnp.float32(LR))
    return dict(jcfg=jcfg, tcfg=tcfg, params=_port(jparams),
                batch={"tokens": torch.from_numpy(np.array(jb["tokens"]))},
                loss=float(loss), grads=_port(grads), logits=np.asarray(logits),
                hidden=np.asarray(hidden), mtp=None if mtp is None else np.asarray(mtp),
                upd=(_port(upd[0]), float(upd[2])))


def _close(got, want, rel, path=""):
    """Every leaf of ``got`` within ``rel`` of the largest element of the
    same leaf of ``want``."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _close(got[k], want[k], rel, f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _close(a, b, rel, f"{path}/{i}")
    else:
        assert got.shape == want.shape and got.dtype == want.dtype, path
        assert torch.all((got - want).abs() <= rel * want.abs().max()), \
            (path, float((got - want).abs().max()))


def test_forward_hidden_and_mtp_logits(ref):
    cfg, params, toks = ref["tcfg"], ref["params"], ref["batch"]["tokens"]
    logits, hidden = deepseek.forward(cfg, params, toks, return_hidden=True)
    assert torch.equal(logits, deepseek.forward(cfg, params, toks))
    np.testing.assert_allclose(logits.numpy(), ref["logits"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(hidden.numpy(), ref["hidden"], rtol=0, atol=1e-4)
    assert ("mtp" in params) == (cfg.mtp_depth > 0)
    if cfg.mtp_depth:
        mtp = deepseek.mtp_logits(cfg, params, toks, hidden)
        assert mtp.shape == (toks.shape[0], toks.shape[1] - 1, cfg.vocab_size)
        np.testing.assert_allclose(mtp.numpy(), ref["mtp"], rtol=0, atol=1e-4)


def test_loss_and_grads_match_reference(ref):
    """V2's loss is the plain CE; V3's adds the MTP term, which the grads
    of its ``mtp`` block show (they are zero without it)."""
    cfg = ref["tcfg"]
    loss, grads = steps.value_and_grad(cfg, ref["params"], ref["batch"])
    assert abs(float(loss) - ref["loss"]) <= 1e-6 * ref["loss"]
    _close(grads, ref["grads"], 1e-5)
    logits = model.forward(cfg, ref["params"], ref["batch"])
    toks = ref["batch"]["tokens"]
    ce = model._ce(logits[:, :-1], toks[:, 1:])
    if cfg.mtp_depth:
        assert float(loss) > float(ce)
        assert float(grads["mtp"]["proj"].abs().max()) > 0
    else:
        assert torch.equal(loss, ce)


def test_adamw_update_decays_as_the_reference(ref):
    """The moe tree's per-layer norms (stacked in the reference: (L, d))
    are decayed, the MTP block's norms ((d,), unstacked) and the final
    norm are not; one update within 1e-6 of the reference's."""
    params = ref["params"]
    dec = optimizer.decays(params)
    assert all(lp["attn_norm"] and lp["mlp_norm"]
               for group in ("dense_layers", "moe_layers") for lp in dec[group])
    assert dec["final_norm"] is False
    if "mtp" in dec:
        assert dec["mtp"]["norm"] is False and dec["mtp"]["block"]["attn_norm"] is False
    want, want_norm = ref["upd"]
    got, _, gnorm = optimizer.adamw_update(params, ref["grads"],
                                           optimizer.adamw_init(params), torch.tensor(LR))
    assert abs(float(gnorm) - want_norm) <= 1e-6 * want_norm
    _close(got, want, 1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_batches_are_the_reference_s(arch):
    jcfg, tcfg = ds_configs(arch)
    it_j, it_t = jax_batches(jcfg, 3, 12, seed=2, start_step=5), batches(
        tcfg, 3, 12, seed=2, start_step=5, device="cpu")
    for _ in range(3):
        (sj, bj), (st, bt) = next(it_j), next(it_t)
        assert sj == st and set(bt) == set(bj) == {"tokens"}
        assert np.array_equal(bt["tokens"].numpy(), np.asarray(bj["tokens"]))
    dense = next(batches(dataclasses.replace(tcfg, family="dense"), 3, 12, seed=2,
                         start_step=5, device="cpu"))[1]
    assert torch.equal(dense["tokens"], next(batches(tcfg, 3, 12, seed=2, start_step=5,
                                                     device="cpu"))[1]["tokens"])
    with pytest.raises(NotImplementedError, match="vlm"):
        next(batches(dataclasses.replace(tcfg, family="vlm"), 1, 4, device="cpu"))


def test_train_reduced_v3_falls_and_resumes_bitwise(tmp_path):
    """Eight steps of ``train`` on the reduced V3 (CE + MTP): the loss falls
    (8.21 -> 6.81 with this seed); four steps, a restart from the step-4
    checkpoint, four more: the same losses and parameters bitwise."""
    _, cfg = ds_configs("deepseek-v3-671b")
    kw = dict(global_batch=8, seq_len=32, lr=1e-2, device="cpu", log=lambda s: None)
    straight, hist, _ = train(cfg, steps=8, **kw)
    assert hist[-1] < hist[0] - 0.5 and all(np.isfinite(hist))
    train(cfg, steps=4, ckpt_dir=str(tmp_path), ckpt_every=4, **kw)
    resumed, tail, _ = train(cfg, steps=8, ckpt_dir=str(tmp_path), ckpt_every=4, **kw)
    assert tail == hist[4:]
    for a, b in zip(optimizer.tree_leaves(resumed.params),
                    optimizer.tree_leaves(straight.params)):
        assert torch.equal(a, b)


def test_train_launcher_on_the_moe_family(capsys):
    assert train_cli.main(["--arch", "deepseek-v3-671b", "--device", "cpu", "--steps", "3",
                           "--batch", "2", "--seq", "16"]) == 0
    assert "3 steps, loss" in capsys.readouterr().out


def test_unported_family_loss_raises():
    _, cfg = ds_configs("deepseek-v2-236b")
    with pytest.raises(NotImplementedError, match="not ported"):
        model.loss_fn(dataclasses.replace(cfg, family="ssm"), {},
                      {"tokens": torch.zeros((1, 4), dtype=torch.long)})


@pytest.mark.parametrize("arch", ARCHS)
def test_absorbed_mla_kernel_route_is_causal(arch):
    """``mla_absorb`` has no kernel: on the kernel route it runs its einsums
    under #7's causal mask from ``q_start``, so forward, prefill and decode
    give the gather route's logits (before the mask was built there, the
    absorbed path attended to every cache row on the kernel route)."""
    jcfg, tcfg = ds_configs(arch)
    cfg = dataclasses.replace(tcfg, mla_absorb=True)
    params = _port(ds_params(jcfg))
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 9)))
    out = {}
    for route in ("kernel", "gather"):
        ctx = KernelContext(attention=route)
        full = model.forward(cfg, params, {"tokens": toks}, ctx=ctx)
        cache = model.init_cache(cfg, 2, 16, torch.float32, device="cpu")
        first, cache = model.prefill(cfg, params, {"tokens": toks[:, :6]}, cache, ctx=ctx)
        rows = [first]
        for i in range(6, 9):
            logits, cache = model.decode_step(cfg, params, toks[:, i:i + 1], cache, ctx=ctx)
            rows.append(logits)
        out[route] = (full, torch.cat(rows, 1))
    for a, b in zip(out["kernel"], out["gather"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)
    # and the cached path is the forward's, row by row
    np.testing.assert_allclose(out["kernel"][1][:, :3].numpy(),
                               out["kernel"][0][:, 5:8].numpy(), rtol=0, atol=1e-5)
