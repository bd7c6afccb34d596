"""The quantize launcher and the structure-only shell, in the port against
the reference: ``QuantPolicy.kv_cache_bits``; ``quant/shell.quantize_shell``
leaf for leaf against the reference's (shapes, dtypes, ``act_group``,
``name``, ``impl``) on the reduced SmolLM and DeepSeek-V2/V3;
``quantized_param_shapes`` on the meta device (nothing allocated, DeepSeek-V3
at full width); the checkpoint's treatment of QLinear's static fields; and
``launch/quantize.main`` on the CPU (RTN and GPTQ, reduced SmolLM), its
checkpoint loaded back through the shell bitwise and served with the
in-memory model's streams.

Every comparison here is exact: shapes, dtypes, names and integer or
float arrays written and read back bitwise.

The reference's split, which the port keeps: the shell quantizes by the
policy's patterns alone, so DeepSeek-V3's MTP block (``mtp/proj`` and the
block's projections) becomes QLinears in the shell, while the moe walker
(``quantize_model``) leaves ``params["mtp"]`` in full precision
(``test_torch_calibrate_moe``).
"""

import dataclasses

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models import model as jax_model
from repro.quant.policy import QuantPolicy as JaxQuantPolicy
from repro.quant.shell import quantize_shell as jax_quantize_shell
from repro_torch import bridge
from repro_torch.checkpoint.ckpt import load_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.launch import quantize as quantize_cli
from repro_torch.models import model
from repro_torch.models.config import reduced
from repro_torch.quant.calibrate import quantize_model
from repro_torch.quant.policy import QuantPolicy
from repro_torch.quant.qlinear import QLinear, retag_qlinear_impl
from repro_torch.quant.shell import param_shapes, quantize_shell, quantized_param_shapes
from repro_torch.serve.engine import Request, ServeEngine
from torch_moe_parity import ds_configs, ds_params
from torch_parity import RTN_SVD, configs, jax_params, to_numpy_tree

POLICY = dict(rank_frac=0.10, act_group=16, act_group_overrides={"mlp/wd": None},
              impl="sim")


def test_kv_cache_bits_is_the_reference_field():
    want = {f.name: f.default for f in dataclasses.fields(JaxQuantPolicy)}
    got = {f.name: f.default for f in dataclasses.fields(QuantPolicy)}
    assert got == want and got["kv_cache_bits"] is None
    assert QuantPolicy(kv_cache_bits=8) == QuantPolicy(kv_cache_bits=8)
    assert QuantPolicy(kv_cache_bits=8) != QuantPolicy()
    assert hash(QuantPolicy(kv_cache_bits=8)) == hash(QuantPolicy(kv_cache_bits=8))


def _shell_pair(jcfg, tcfg, jparams):
    """The reference's shell (numpy, stacked) and the port's, restacked."""
    want = to_numpy_tree(jax_quantize_shell(jparams, JaxQuantPolicy(**POLICY)))
    port = bridge.params_from_jax(to_numpy_tree(jparams), device="cpu")
    got = quantize_shell(port, QuantPolicy(**POLICY))
    return want, got, bridge.params_to_numpy(got, bf16_dtype=ml_dtypes.bfloat16)


def _same_layout(got, want, path=""):
    """Shapes, dtypes, static fields and bytes equal, leaf for leaf (the
    QLinears' arrays are zeros, the other leaves the bridged params)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _same_layout(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        assert got.shape == want.shape and got.dtype == want.dtype, path
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), path
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-v2-236b", "deepseek-v3-671b"])
def test_shell_is_the_reference_s(arch):
    if arch == "smollm-135m":
        jcfg, tcfg = configs()
        jparams = jax_params(jcfg)
    else:
        jcfg, tcfg = ds_configs(arch)
        jparams = ds_params(jcfg)
    want, got, got_np = _shell_pair(jcfg, tcfg, jparams)
    _same_layout(got_np, want)
    # the reference's paths: no layer index ("layers/attn/wq")
    names = [q.name for q in _qlinears(got)]
    assert names and all(not any(p.isdigit() for p in n.split("/")) for n in names)
    groups = {q.name: q.act_group for q in _qlinears(got)}
    assert all(g == (None if n.endswith("mlp/wd") else 16) for n, g in groups.items())
    if arch == "deepseek-v3-671b":
        # the shell's split from the walker: mtp/proj (and the MTP block) are
        # QLinears here, plain in what the moe walker returns
        assert isinstance(got["mtp"]["proj"], QLinear)
        assert got["mtp"]["proj"].name == "mtp/proj"
        port = bridge.params_from_jax(to_numpy_tree(jparams), device="cpu")
        walked = quantize_model(tcfg, port, None, QuantPolicy(**RTN_SVD), rotate=False)
        assert isinstance(walked["mtp"]["proj"], torch.Tensor)
        assert torch.equal(walked["mtp"]["proj"], port["mtp"]["proj"])


def _qlinears(tree):
    if isinstance(tree, QLinear):
        return [tree]
    if isinstance(tree, dict):
        return [q for v in tree.values() for q in _qlinears(v)]
    if isinstance(tree, list):
        return [q for v in tree for q in _qlinears(v)]
    return []


def test_shell_keeps_expert_dims_and_rank_zero():
    _, tcfg = ds_configs("deepseek-v2-236b")
    params = model.init_params(tcfg, seed=0, device="cpu")
    shell = quantize_shell(params, QuantPolicy(rank_frac=0.0))
    ex = shell["moe_layers"][0]["moe"]["experts"]["wg"]
    e, d, f = params["moe_layers"][0]["moe"]["experts"]["wg"].shape
    assert ex.qweight.shape == (e, d // 2, f) and ex.qweight.dtype == torch.uint8
    assert ex.w_scale.shape == (e, f) and ex.w_scale.dtype == torch.float32
    assert ex.u is None and ex.v is None and ex.name == "moe_layers/moe/experts/wg"
    assert torch.equal(shell["moe_layers"][0]["moe"]["router"],
                       params["moe_layers"][0]["moe"]["router"])


def test_quantized_param_shapes_allocates_nothing():
    """DeepSeek-V3 at full width (hundreds of GB as bf16 weights): every
    tensor of the quantized tree is on the meta device."""
    cfg = get_config("deepseek-v3-671b")
    shapes = quantized_param_shapes(cfg, QuantPolicy())
    leaves = [t for q in _qlinears(shapes) for t in (q.qweight, q.w_scale, q.u, q.v)]
    leaves += [shapes["embed"], shapes["lm_head"], shapes["final_norm"]]
    assert all(t.device.type == "meta" for t in leaves)
    ex = shapes["moe_layers"][0]["moe"]["experts"]["wd"]
    assert ex.qweight.shape == (cfg.n_experts, cfg.d_expert // 2, cfg.d_model)
    assert len(shapes["moe_layers"]) == cfg.n_layers - cfg.n_dense_layers
    # a rotated tied dense model carries the lm_head QuaRot materializes
    small = reduced(get_config("smollm-135m"))
    assert "lm_head" not in param_shapes(small)
    assert param_shapes(small, rotated=True)["lm_head"].shape == (small.d_model,
                                                                  small.vocab_size)


def test_checkpoint_takes_static_fields_from_the_tree(tmp_path):
    """A QLinear's arrays are stored (``u``/``v`` None: nothing), its
    static fields are not: a load takes them from ``like``."""
    q = QLinear(qweight=torch.arange(12, dtype=torch.uint8).reshape(2, 6),
                w_scale=torch.linspace(0.5, 1.0, 6), u=None, v=None, act_group=8,
                impl="sim", name="attn/wq")
    path = save_checkpoint(tmp_path, 0, {"w": q})
    like = {"w": dataclasses.replace(q, qweight=torch.zeros_like(q.qweight),
                                     w_scale=torch.zeros_like(q.w_scale), impl="int8",
                                     name="layers/attn/wq")}
    back = load_checkpoint(path, like)["w"]
    assert torch.equal(back.qweight, q.qweight) and torch.equal(back.w_scale, q.w_scale)
    assert (back.u, back.v, back.impl, back.name, back.act_group) == (
        None, None, "int8", "layers/attn/wq", 8)


def _arrays(tree):
    from repro_torch.train.optimizer import tree_leaves

    out = []
    for leaf in tree_leaves(tree):
        if isinstance(leaf, QLinear):
            out += [leaf.qweight, leaf.w_scale, leaf.u, leaf.v]
        else:
            out.append(leaf)
    return out


def _streams(cfg, params):
    eng = ServeEngine(cfg, params, batch_slots=2, max_seq=32, page_size=4,
                      prefill_chunk=4, device="cpu")
    rng = np.random.default_rng(9)
    for i in range(3):
        eng.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 5 + i)
                           .astype(np.int32), max_new_tokens=5))
    return {rid: r.out_tokens for rid, r in eng.run().items()}


@pytest.mark.parametrize("method", ["rtn", "gptq"])
def test_launcher_output_loads_bitwise_and_serves(tmp_path, method, capsys):
    """``launch.quantize`` from a model checkpoint (reduced SmolLM, random
    weights): per-layer progress printed; its output loads through
    ``quantized_param_shapes(..., rotated=True)`` bitwise on every array;
    after ``retag_qlinear_impl`` the loaded model serves the in-memory
    model's streams, on the int8 path and on the kernel path's plain
    versions."""
    cfg = reduced(get_config("smollm-135m"))
    src = save_checkpoint(tmp_path / "model", 0, model.init_params(cfg, seed=3, device="cpu"))
    argv = ["--device", "cpu", "--ckpt", src, "--out", str(tmp_path / "q"),
            "--method", method, "--calib-seqs", "4", "--calib-len", "32"]
    assert quantize_cli.main(argv) == 0
    out = capsys.readouterr().out
    assert f"layer {cfg.n_layers}/{cfg.n_layers}" in out and "saved to" in out
    tcfg, policy, qparams, path = quantize_cli.quantize(argv)
    assert policy == QuantPolicy(rank_frac=0.10, impl="sim", quant_method=method)
    back = load_checkpoint(path, quantized_param_shapes(tcfg, policy, rotated=True),
                           device="cpu")
    got, want = _arrays(back), _arrays(qparams)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a is None and b is None) or (a.dtype == b.dtype and torch.equal(a, b))
    assert {q.impl for q in _qlinears(back)} == {"sim"}
    for impl in ("int8", "pallas"):
        assert _streams(tcfg, retag_qlinear_impl(back, impl)) == \
            _streams(tcfg, retag_qlinear_impl(qparams, impl))


def test_launcher_refuses_a_cut_without_moe_layers():
    with pytest.raises(SystemExit):
        quantize_cli.main(["--arch", "deepseek-v2-236b", "--device", "cpu",
                           "--layers", "1"])
