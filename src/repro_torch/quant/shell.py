"""Structure-only quantization (counterpart of ``repro/quant/shell.py``):
map a param tree to its quantized layout, QLinear leaves of zeros, without
running any calibration.

A checkpoint of a quantized model (``launch/quantize.py``) loads into this
tree: ``load_checkpoint(path, like=quantize_shell(params, policy))`` takes
the arrays from the file and every QLinear's static fields (bits, groups,
clip, impl, name) from the shell.  The calibrating walker
(``quant/calibrate.py``) produces the same arrays with solved values.

The shell selects sites by the policy's patterns alone, as the reference's
does, so for DeepSeek-V3 it quantizes the MTP block (``mtp/proj`` and the
block's projections), which the moe walker leaves in full precision: a V3
checkpoint of the walker does not load into V3's shell, in the reference
as here.
"""

from __future__ import annotations

import torch

from repro_torch.bridge import STACKED_KEYS
from repro_torch.quant.policy import QuantPolicy, path_str
from repro_torch.quant.qlinear import QLinear


def _shell_leaf(leaf: torch.Tensor, ps: str, policy: QuantPolicy) -> QLinear:
    """A zero QLinear of ``leaf``'s (..., d_in, d_out) weight, its leading
    (expert) dims kept."""
    *lead, d_in, d_out = leaf.shape
    lead = tuple(lead)
    k = policy.rank(d_in, d_out)
    zeros = lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=leaf.device)
    return QLinear(
        qweight=zeros(lead + (d_in // 2, d_out), torch.uint8),
        w_scale=zeros(lead + (d_out,), torch.float32),
        u=zeros(lead + (d_out, k), torch.bfloat16) if k else None,
        v=zeros(lead + (d_in, k), torch.bfloat16) if k else None,
        bits=policy.bits, act_bits=policy.act_bits,
        # per-layer granularity, as the calibrating walker gives it
        act_group=policy.act_group_for(ps), clip_ratio=policy.clip_ratio,
        impl=policy.impl, name=ps)


def quantize_shell(params, policy: QuantPolicy):
    """Replace every weight leaf ``policy.should_quantize`` selects with a
    zero QLinear of the reference's shapes and dtypes: ``qweight`` uint8
    (…, d_in/2, d_out), ``w_scale`` f32 (…, d_out), ``u``/``v`` bf16 (…,
    d_out | d_in, rank), or None at rank 0.  A leaf's path is the
    reference's (``path_str`` of its stacked tree): a layer list's index is
    left out, so the first layer's ``wq`` is ``"layers/attn/wq"``, the
    ``name`` the QLinear carries."""

    def convert(node, path):
        if isinstance(node, dict):
            return {k: convert(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            # the port's list of layers is the reference's stacked axis
            keep = not (path and path[-1] in STACKED_KEYS)
            return [convert(v, path + ((i,) if keep else ())) for i, v in enumerate(node)]
        ps = path_str(path)
        if node is None or not policy.should_quantize(ps, node.shape):
            return node
        return _shell_leaf(node, ps, policy)

    return convert(params, ())


def param_shapes(cfg, rotated: bool = False):
    """The float param tree of ``cfg`` on ``device="meta"``: every tensor
    has its shape and dtype and no storage.  The params are traced under
    ``FakeTensorMode``, so nothing is allocated at any width.  ``rotated``
    adds the explicit ``lm_head`` that QuaRot's rotation
    (``quant/rotate.py``) gives a tied dense model."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import model as model_lib
    from repro_torch.train.optimizer import tree_map

    with FakeTensorMode():
        fake = model_lib.init_params(cfg, 0, device="cpu")
    params = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), fake)
    if rotated and cfg.family == "dense" and "lm_head" not in params:
        params["lm_head"] = torch.empty((cfg.d_model, cfg.vocab_size),
                                        dtype=params["embed"].dtype, device="meta")
    return params


def quantized_param_shapes(cfg, policy: QuantPolicy, rotated: bool = False):
    """The quantized model's tree on ``device="meta"`` (the reference's
    ``jax.eval_shape`` of :func:`quantize_shell`): :func:`quantize_shell`
    of :func:`param_shapes`.  ``rotated`` as there: the tree of a model the
    walker calibrated with its default rotation, as ``launch/quantize.py``
    writes it."""
    return quantize_shell(param_shapes(cfg, rotated), policy)
