"""Per-site W4A4 quantization of a dense model — the calibration-free
branch of ``repro/quant/calibrate.py``.

With ``quant_method="rtn"`` and ``correction`` in ``svd``/``none`` the
reference's solver reads no activation statistics: RTN quantizes each
weight on its own and the SVD correction factors the weight residual.  So
``quantize_model`` here walks the sites in the reference's order and
solves each from its weight alone; ``calib_tokens`` is accepted for the
reference's signature and not read.  LRC (Algorithm 1), GPTQ and the
QuaRot rotation need the statistics walk and come with the calibration
slice (ROADMAP Queue 1).
"""

from __future__ import annotations

import torch

from repro_torch.core.lrc import quantize_baseline, svd_correction
from repro_torch.core.quantizers import QuantSpec
from repro_torch.quant.policy import QuantPolicy
from repro_torch.quant.qlinear import QLinear, make_qlinear

_LATER = "comes with the calibration slice (ROADMAP Queue 1)"


def solve_site(w, stats, policy: QuantPolicy, pre_rot: bool = False,
               name: str = None) -> QLinear:
    """w: model-layout (d_in, d_out).  Solves Ŵ and, for ``svd``, (U, V)."""
    if policy.correction == "lrc":
        raise NotImplementedError(f"correction='lrc' {_LATER}")
    if policy.quant_method != "rtn":
        raise NotImplementedError(
            f"quant_method={policy.quant_method!r} {_LATER}")
    if policy.act_group is not None:
        raise NotImplementedError(f"act_group {_LATER}")
    w_paper = w.to(torch.float64).T  # (d_out, d_in)
    spec_w = QuantSpec(bits=policy.bits)
    k = policy.rank(w.shape[0], w.shape[1])
    q, s, w_hat = quantize_baseline(w_paper, stats, spec_w,
                                    quant_method=policy.quant_method)
    u = v = None
    if policy.correction == "svd" and k > 0:
        u, v = svd_correction(w_paper, w_hat, k)
    return make_qlinear(q, s, u, v, act_bits=policy.act_bits,
                        act_group=policy.act_group,
                        clip_ratio=policy.clip_ratio, impl=policy.impl,
                        name=name)


_SITES = (("attn", ("wq", "wk", "wv", "wo")), ("mlp", ("wg", "wu", "wd")))


def quantize_model(cfg, params, calib_tokens, policy: QuantPolicy,
                   rotate: bool = True):
    """Returns params whose seven linears per layer are solved QLinears,
    walking the sites as the reference's ``_dense_layer_walk`` does."""
    if rotate:
        raise NotImplementedError(f"rotate=True (QuaRot fusion) {_LATER}")
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported; only 'dense' is")
    layers = []
    for lp in params["layers"]:
        qlp = dict(lp)
        for block, names in _SITES:
            qlp[block] = {n: solve_site(lp[block][n], None, policy,
                                        name=f"{block}/{n}") for n in names}
        layers.append(qlp)
    out = dict(params)
    out["layers"] = layers
    return out
