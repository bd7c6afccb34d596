"""Sequential per-layer LRC calibration — the paper's full pipeline
(counterpart of ``repro/quant/calibrate.py``, dense family):

  (1) QuaRot-style rotation fusion (``quant/rotate.py``), then
  (2) "LRC works sequentially through the weight matrices of the model,
       computing activations for each weight matrix, obtaining the
       covariance and cross-covariances matrices needed to apply Algorithm 1
       ... before moving to the next layer."  (paper §3)

The walker keeps a running f32 activation stream X (all calibration
sequences at once); after solving a layer's weights it re-propagates the
stream through the QUANTIZED layer, so later layers calibrate against the
inputs they will see deployed.  The QLinears of the walk apply with
``policy.impl``.  Statistics and solvers run in float64 on the device of
the params; the walk's causal attention takes the route of
``ctx.attention`` (``kernels/context.py``): on the card the hand-written
flash-attention kernel, which never builds the (B, H, S, S) logits.

``resume_dir`` keeps one ``layer_NNN.pt`` per finished layer (the layer's
params and the stream after it, written with ``torch.save`` and read with
``weights_only=True``), so a killed calibration resumes where it stopped
and gives the same result, bitwise.

Ported: the dense and moe families; ``solve_site`` with lrc / svd / none
over gptq or rtn; group-wise activation scales (``policy.act_group``): the
statistics quantize with the policy-wide group, and each QLinear is tagged
with ``policy.act_group_for(name)``, so an override changes the layer's
serving scales but not the statistics it was solved from, as in the
reference.  The moe walker (DeepSeek: MLA projections, the shared experts
and each routed expert on the tokens the router sends it) solves its sites
unnamed, as the reference's does.  Not ported (it raises): the ssm walker
(ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.hadamard import apply_rotation
from repro_torch.core.lrc import lrc_solve, quantize_baseline, svd_correction
from repro_torch.core.quantizers import QuantSpec
from repro_torch.core.stats import accumulate_stats, finalize_stats, init_stats
from repro_torch.kernels.ops import DEFAULT_CONTEXT
from repro_torch.models.common import (_project_qkv, causal_attention,
                                       causal_mask, rms_norm, rope_table)
from repro_torch.models.transformer import embed_tokens
from repro_torch.models.deepseek import LAYER_GROUPS
from repro_torch.models.mla import mla_attention_pre_o, mla_rope_table
from repro_torch.models.moe import moe_block, router_weights
from repro_torch.quant.policy import QuantPolicy, path_str
from repro_torch.quant.qlinear import (QLinear, apply_linear, make_qlinear,
                                       stack_experts)
from repro_torch.quant.rotate import rotate_model

STATS_CHUNK = 65536  # activation rows per statistics update


# ---------------------------------------------------------------------------
# single-site solver
# ---------------------------------------------------------------------------


def collect_stats(acts, spec_a: QuantSpec, pre_rot: bool = False):
    """acts: (..., d) activation batch → finalized CalibStats (float64, on
    the activations' device)."""
    x = acts.reshape(-1, acts.shape[-1])
    if pre_rot:
        x = apply_rotation(x, x.shape[-1])
    st = init_stats(x.shape[-1], device=x.device)
    for i in range(0, x.shape[0], STATS_CHUNK):
        st = accumulate_stats(st, x[i:i + STATS_CHUNK], spec_a)
    return finalize_stats(st)


def solve_site(w, stats, policy: QuantPolicy, pre_rot: bool = False,
               name: str = None) -> QLinear:
    """w: model-layout (d_in, d_out).  Solves Ŵ and (U, V) per the policy;
    ``name`` tags the QLinear, whose activation group is
    ``policy.act_group_for(name)``.  RTN without a correction, or with the
    SVD one, reads no statistics (``stats`` may be None)."""
    w_paper = w.to(torch.float64).T  # (d_out, d_in)
    spec_w = QuantSpec(bits=policy.bits)
    k = policy.rank(w.shape[0], w.shape[1])
    if policy.correction == "lrc" and k > 0:
        res = lrc_solve(w_paper, stats, spec_w, k=k, iters=policy.lrc_iters,
                        quant_method=policy.quant_method)
        q, s, u, v = res.qweight, res.scales, res.u, res.v
    elif policy.correction == "svd" and k > 0:
        q, s, w_hat = quantize_baseline(w_paper, stats, spec_w,
                                        quant_method=policy.quant_method,
                                        hessian="x")
        u, v = svd_correction(w_paper, w_hat, k)
    else:
        q, s, _ = quantize_baseline(w_paper, stats, spec_w,
                                    quant_method=policy.quant_method,
                                    hessian="x")
        u = v = None
    return make_qlinear(q, s, u, v, act_bits=policy.act_bits,
                        act_group=policy.act_group_for(name),
                        clip_ratio=policy.clip_ratio, impl=policy.impl,
                        name=name)


def _act_spec(policy: QuantPolicy) -> QuantSpec:
    return QuantSpec(bits=policy.act_bits, clip_ratio=policy.clip_ratio,
                     group_size=policy.act_group)


# ---------------------------------------------------------------------------
# dense walker
# ---------------------------------------------------------------------------


def _dense_layer_walk(cfg, lp, x, positions, mask, policy, route="gather",
                      rope_cs=None):
    """Quantize one dense layer; returns (quantized layer params, new x).
    ``mask`` is the aligned causal mask, read on the reference's route
    (None: built when needed); ``rope_cs`` the RoPE tables of
    ``positions`` (computed here when None)."""
    spec_a = _act_spec(policy)
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    st = collect_stats(h, spec_a)
    qattn = {name: solve_site(lp["attn"][name], st, policy, name=f"attn/{name}")
             for name in ("wq", "wk", "wv")}

    # attention with the QUANTIZED projections (deployment-faithful stream)
    b, s, _ = x.shape
    if rope_cs is None and cfg.rope_theta > 0:
        rope_cs = rope_table(positions, cfg.head_dim, cfg.rope_theta)
    q, k, v = _project_qkv(qattn, h, positions, cfg, rope_cs)
    pre_o = causal_attention(q, k, v, 1.0 / (cfg.head_dim**0.5), route,
                             mask).reshape(b, s, cfg.q_dim)
    del q, k, v

    st_o = collect_stats(pre_o, spec_a)
    qattn["wo"] = solve_site(lp["attn"]["wo"], st_o, policy, name="attn/wo")
    x = x + apply_linear(qattn["wo"], pre_o)
    del pre_o

    h2 = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    st2 = collect_stats(h2, spec_a)
    qmlp = {"wg": solve_site(lp["mlp"]["wg"], st2, policy, name="mlp/wg"),
            "wu": solve_site(lp["mlp"]["wu"], st2, policy, name="mlp/wu")}
    g = apply_linear(qmlp["wg"], h2)
    u = apply_linear(qmlp["wu"], h2)
    hidden = (F.silu(g) if cfg.act == "silu"
              else F.gelu(g, approximate="tanh")) * u
    del g, u
    st3 = collect_stats(hidden, spec_a)
    qmlp["wd"] = solve_site(lp["mlp"]["wd"], st3, policy, name="mlp/wd")
    x = x + apply_linear(qmlp["wd"], hidden)
    return dict(lp, attn=qattn, mlp=qmlp), x


_QLINEAR_ARRAYS = ("qweight", "w_scale", "u", "v")


def _to_state(node):
    """A layer's params as plain dicts of tensors and scalars (a QLinear
    as a tagged dict of its fields; its run-time ``ctx`` does not travel),
    which ``torch.load(weights_only=True)`` reads back."""
    if isinstance(node, QLinear):
        return {"__qlinear__": {f.name: getattr(node, f.name)
                                for f in dataclasses.fields(node)
                                if f.name != "ctx"}}
    if isinstance(node, dict):
        return {k: _to_state(v) for k, v in node.items()}
    return node


def _from_state(node, device):
    if isinstance(node, dict):
        if "__qlinear__" in node:
            fields = dict(node["__qlinear__"])
            for k in _QLINEAR_ARRAYS:
                if fields[k] is not None:
                    fields[k] = fields[k].to(device)
            return QLinear(**fields)
        return {k: _from_state(v, device) for k, v in node.items()}
    return node.to(device) if isinstance(node, torch.Tensor) else node


def _save_layer(path: Path, qlp, x) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save({"layer": _to_state(qlp), "x": x}, tmp)
    tmp.replace(path)  # a killed save leaves no half-written checkpoint


def _load_layer(path: Path, device):
    state = torch.load(path, map_location="cpu", weights_only=True)
    return _from_state(state["layer"], device), state["x"].to(device)


def _quantize_dense(cfg, params, tokens, policy, progress=None,
                    resume_dir: Optional[Path] = None, ctx=None):
    x = embed_tokens(cfg, params, tokens).to(torch.float32)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    route = (DEFAULT_CONTEXT if ctx is None else ctx).attention_route(
        x.device, cfg.head_dim)
    mask = None if route == "kernel" else causal_mask(s, s, 0, device=x.device)
    rope_cs = (rope_table(positions, cfg.head_dim, cfg.rope_theta)
               if cfg.rope_theta > 0 else None)
    new_layers = []
    for li, lp in enumerate(params["layers"]):
        ck = resume_dir / f"layer_{li:03d}.pt" if resume_dir else None
        if ck is not None and ck.exists():
            qlp, x = _load_layer(ck, x.device)
        else:
            qlp, x = _dense_layer_walk(cfg, lp, x, positions, mask, policy,
                                       route, rope_cs)
            if ck is not None:
                _save_layer(ck, qlp, x)
        new_layers.append(qlp)
        if progress:
            progress(li, cfg.n_layers)
    return dict(params, layers=new_layers)


# ---------------------------------------------------------------------------
# moe (deepseek) walker
# ---------------------------------------------------------------------------


def _gated(qp, x):
    """SwiGLU's hidden activations through the QUANTIZED gate and up
    projections (the input of ``wd``)."""
    return F.silu(apply_linear(qp["wg"], x)) * apply_linear(qp["wu"], x)


def _solve_expert_sites(cfg, experts, x_tok, weights, policy):
    """Per-expert statistics: each routed expert calibrates on the tokens
    the router sends it (the paper quantizes Mixtral the same way); an
    expert sent fewer than 8 tokens calibrates on all of them.  Returns the
    three sites as QLinears stacked on the expert axis."""
    spec_a = _act_spec(policy)
    qg, qu, qd = [], [], []
    for ei in range(cfg.n_experts):
        sel = weights[:, ei] > 0
        xe = x_tok[sel] if int(sel.sum()) >= 8 else x_tok
        st = collect_stats(xe, spec_a)
        qe = {"wg": solve_site(experts["wg"][ei], st, policy),
              "wu": solve_site(experts["wu"][ei], st, policy)}
        qg.append(qe["wg"])
        qu.append(qe["wu"])
        qd.append(solve_site(experts["wd"][ei],
                             collect_stats(_gated(qe, xe), spec_a), policy))
    return {"wg": stack_experts(qg), "wu": stack_experts(qu),
            "wd": stack_experts(qd)}


def _moe_layer_walk(cfg, lp, x, positions, mask, policy, moe: bool,
                    route="gather", rope_cs=None):
    """Quantize one DeepSeek layer (MLA, then the dense FFN or the MoE
    block); returns (quantized layer params, new x).  ``mask`` and
    ``route`` as in :func:`_dense_layer_walk`."""
    spec_a = _act_spec(policy)
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    st_h = collect_stats(h, spec_a)
    qattn = dict(lp["attn"])
    if "wq_a" in qattn:
        qattn["wq_a"] = solve_site(lp["attn"]["wq_a"], st_h, policy)
        cq = rms_norm(apply_linear(qattn["wq_a"], h), lp["attn"]["q_norm"], cfg.norm_eps)
        qattn["wq_b"] = solve_site(lp["attn"]["wq_b"], collect_stats(cq, spec_a), policy)
        del cq
    else:
        qattn["wq"] = solve_site(lp["attn"]["wq"], st_h, policy)
    qattn["wkv_a"] = solve_site(lp["attn"]["wkv_a"], st_h, policy)
    kv = apply_linear(qattn["wkv_a"], h)
    c_kv = rms_norm(kv[..., :cfg.kv_lora_rank], lp["attn"]["kv_norm"], cfg.norm_eps)
    qattn["wkv_b"] = solve_site(lp["attn"]["wkv_b"], collect_stats(c_kv, spec_a), policy)
    del kv, c_kv

    # the QUANTIZED projections' attention, before wo (deployment-faithful)
    pre_o, _ = mla_attention_pre_o(cfg, qattn, h, positions, mask, None, route, rope_cs)
    qattn["wo"] = solve_site(lp["attn"]["wo"], collect_stats(pre_o, spec_a), policy)
    x = x + apply_linear(qattn["wo"], pre_o)
    del pre_o

    h2 = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    st2 = collect_stats(h2, spec_a)
    qlp = dict(lp, attn=qattn)
    if moe:
        qmoe = dict(lp["moe"])
        if "shared" in qmoe:
            qsh = {"wg": solve_site(qmoe["shared"]["wg"], st2, policy),
                   "wu": solve_site(qmoe["shared"]["wu"], st2, policy)}
            qsh["wd"] = solve_site(qmoe["shared"]["wd"],
                                   collect_stats(_gated(qsh, h2), spec_a), policy)
            qmoe["shared"] = qsh
        xt = h2.reshape(-1, h2.shape[-1])
        weights, _ = router_weights(cfg, lp["moe"], xt)
        qmoe["experts"] = _solve_expert_sites(cfg, lp["moe"]["experts"], xt,
                                              weights, policy)
        qlp["moe"] = qmoe
        x = x + moe_block(cfg, qmoe, h2, impl="dense")
    else:
        qmlp = {"wg": solve_site(lp["mlp"]["wg"], st2, policy),
                "wu": solve_site(lp["mlp"]["wu"], st2, policy)}
        hid = _gated(qmlp, h2)
        qmlp["wd"] = solve_site(lp["mlp"]["wd"], collect_stats(hid, spec_a), policy)
        qlp["mlp"] = qmlp
        x = x + apply_linear(qmlp["wd"], hid)
    return qlp, x


def _quantize_moe(cfg, params, tokens, policy, progress=None,
                  resume_dir: Optional[Path] = None, ctx=None):
    """The leading dense-FFN layers, then the MoE layers, on one stream.
    ``progress(done, n_layers)`` after each layer (done counts from 1, as
    in the reference's moe walker); ``resume_dir`` keeps one
    ``{group}_NNN.pt`` per finished layer, as the dense walker does."""
    x = embed_tokens(cfg, params, tokens).to(torch.float32)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    route = (DEFAULT_CONTEXT if ctx is None else ctx).attention_route(
        x.device, cfg.attn_head_dim)
    mask = None if route == "kernel" else causal_mask(s, s, 0, device=x.device)
    rope_cs = mla_rope_table(cfg, positions)
    out = dict(params)
    done = 0
    for group, _, moe in LAYER_GROUPS:
        if group not in params:
            continue
        new_layers = []
        for li, lp in enumerate(params[group]):
            ck = resume_dir / f"{group}_{li:03d}.pt" if resume_dir else None
            if ck is not None and ck.exists():
                qlp, x = _load_layer(ck, x.device)
            else:
                qlp, x = _moe_layer_walk(cfg, lp, x, positions, mask, policy, moe,
                                         route, rope_cs)
                if ck is not None:
                    _save_layer(ck, qlp, x)
            new_layers.append(qlp)
            done += 1
            if progress:
                progress(done, cfg.n_layers)
        out[group] = new_layers
    return out


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def quantize_model(cfg, params, calib_tokens, policy: QuantPolicy,
                   rotate: bool = True, progress=None,
                   resume_dir: Optional[str] = None, ctx=None):
    """Returns params whose seven linears per layer are solved QLinears.
    ``calib_tokens``: (n_seq, S) integer tokens (moved to the params'
    device); RTN with an SVD or no correction reads none (None is
    accepted).  ``rotate`` fuses the QuaRot rotation first.  ``progress(l,
    n_layers)`` is called after each layer; ``ctx`` (a ``KernelContext``,
    None = "auto") picks the walk's attention route."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"the calibration walker of family {cfg.family!r} is not ported; "
            f"only 'dense' and 'moe' are")
    if cfg.family == "moe" and cfg.attn_kind != "mla":
        raise NotImplementedError(
            f"the moe walker runs DeepSeek's MLA layers; attn_kind "
            f"{cfg.attn_kind!r} is not ported for family 'moe'")
    if rotate:
        params = rotate_model(cfg, params)
    if calib_tokens is None:
        if policy.quant_method != "rtn" or policy.correction == "lrc":
            raise ValueError(f"{policy.quant_method} + {policy.correction} "
                             f"needs calibration tokens")
        if cfg.family == "moe":
            return _quantize_moe_weights_only(params, policy)
        return _quantize_weights_only(params, policy)
    tokens = torch.as_tensor(calib_tokens).to(params["embed"].device)
    rd = Path(resume_dir) if resume_dir else None
    walk = _quantize_moe if cfg.family == "moe" else _quantize_dense
    return walk(cfg, params, tokens, policy, progress=progress, resume_dir=rd,
                ctx=ctx)


_SITES = (("attn", ("wq", "wk", "wv", "wo")), ("mlp", ("wg", "wu", "wd")))


def _quantize_weights_only(params, policy):
    """RTN with an SVD or no correction solves each site from its weight
    alone, so no activation is walked: the same QLinears as the walk."""
    layers = []
    for lp in params["layers"]:
        qlp = dict(lp)
        for block, names in _SITES:
            qlp[block] = {n: solve_site(lp[block][n], None, policy,
                                        name=f"{block}/{n}") for n in names}
        layers.append(qlp)
    return dict(params, layers=layers)


def _solve_tree(node, policy, path):
    """A layer's subtree with every site ``policy.should_quantize`` picks
    solved from its weight alone (unnamed, as the moe walker's); a 3-D
    expert stack is solved expert by expert and stacked."""
    if isinstance(node, dict):
        return {k: _solve_tree(v, policy, path + (k,)) for k, v in node.items()}
    if not (isinstance(node, torch.Tensor)
            and policy.should_quantize(path_str(path), node.shape)):
        return node
    if node.dim() == 3:
        return stack_experts([solve_site(w, None, policy) for w in node])
    return solve_site(node, None, policy)


def _quantize_moe_weights_only(params, policy):
    """The weights-only path of a DeepSeek tree: the sites of the walked
    layer groups (the reference's site patterns, ``should_quantize``), the
    same QLinears as the moe walk; the router, norms, embedding, lm head
    and the MTP block stay float, as the walk leaves them."""
    out = dict(params)
    for group, _, _ in LAYER_GROUPS:
        if group in params:
            out[group] = [_solve_tree(lp, policy, (group,)) for lp in params[group]]
    return out
