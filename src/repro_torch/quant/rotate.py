"""QuaRot-style rotation fusion on model parameters (LRC stage 1;
counterpart of ``repro/quant/rotate.py``).

Residual-stream rotation R (Hadamard-structured, orthogonal), on the
port's layout (weights (d_in, d_out), ``params["layers"]`` a list):
  * RMSNorm γ's are folded into their reader weights (the norm becomes a
    pure RMS, which commutes with any orthogonal R);
  * readers  (x @ W, x in the stream):  W ← Rᵀ W
  * writers  (y writes to the stream):  W ← W R
  * embedding rows:                     E ← E R
  * lm head: γ_final folded, then W ← Rᵀ W.  A tied head is UNTIED first
    (γ cannot be folded into a shared table): the result holds an
    ``lm_head``, which ``unembed`` prefers, whatever the config's
    ``tie_embeddings`` says.

Each fold and each product runs in f32 and rounds back to the weight's
dtype, as the reference does.  The model's output is preserved up to
float error.
"""

from __future__ import annotations

import torch

from repro_torch.core.rotation import residual_rotation

F32 = torch.float32


def _fold_gamma(w, gamma):  # W ← diag(γ) W  (rows of W index the input)
    return (gamma.to(F32)[:, None] * w.to(F32)).to(w.dtype)


def _read(w, r):  # W ← Rᵀ W
    return (r.T @ w.to(F32)).to(w.dtype)


def _write(w, r):  # W ← W R
    return (w.to(F32) @ r).to(w.dtype)


def rotate_dense(cfg, params, seed: int = 0):
    """Rotate a dense transformer's params; returns new params (the input
    is not modified)."""
    r = residual_rotation(cfg.d_model, seed, device=params["embed"].device)
    layers = []
    for lp in params["layers"]:
        attn, mlp = dict(lp["attn"]), dict(lp["mlp"])
        for k in ("wq", "wk", "wv"):
            attn[k] = _read(_fold_gamma(attn[k], lp["attn_norm"]), r)
        attn["wo"] = _write(attn["wo"], r)
        for k in ("wg", "wu"):
            mlp[k] = _read(_fold_gamma(mlp[k], lp["mlp_norm"]), r)
        mlp["wd"] = _write(mlp["wd"], r)
        layers.append(dict(lp, attn=attn, mlp=mlp,
                           attn_norm=torch.ones_like(lp["attn_norm"]),
                           mlp_norm=torch.ones_like(lp["mlp_norm"])))
    p = dict(params, layers=layers)
    head = p["lm_head"] if "lm_head" in p else p["embed"].T
    p["lm_head"] = _read(_fold_gamma(head, p["final_norm"]), r)
    p["final_norm"] = torch.ones_like(p["final_norm"])
    p["embed"] = _write(p["embed"], r)
    return p


def rotate_model(cfg, params, seed: int = 0):
    if cfg.family in ("dense", "vlm"):
        return rotate_dense(cfg, params, seed)
    if cfg.family == "ssm":
        raise NotImplementedError(
            "rotation of the ssm family is not ported (it comes with that "
            "family's walker)")
    # moe / hybrid / encdec: the reference returns the params unchanged
    # (LRC applies regardless; the statistics absorb the basis)
    return params
