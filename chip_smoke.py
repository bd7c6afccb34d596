#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel of the port from ``src/repro_torch/kernels/csrc``
     (``build.KERNELS``, seven: one ``nvcc`` per source, all at once);
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the serving and calibration paths give it plus ragged ones,
     with times: the fused kernel at SmolLM-135M's sites, the prologue,
     GEMM and quantizer kernels at Phi-3-mini's, the two paged attention
     kernels at both models' decode shapes and one long ragged Phi-3 batch
     (f32 and bf16 pools, int8 and int4 pools), with an inactive row and
     garbage in the pages no row owns, and the dense causal flash-attention
     kernel at SmolLM's calibration shape, Phi-3's heads (f32, bf16), a
     ragged S and S = 1;
  4. serve SmolLM-135M at full width (random weights from seed 0, W4A4+LRC
     by RTN+SVD, f32 KV pool) through ``ServeEngine.submit``/``run`` and
     count that every QLinear went through the fused kernel and every
     decode step's attention through the paged attention kernel;
  5. the same model's teacher-forced ``paged_step``, kernel path against the
     plain ``int8`` QLinear impl;
  6. serve Phi-3-mini at full width (PHI3_LAYERS layers) on the
     same traffic: every QLinear demotes to the chained path (prologue →
     GEMM kernel), shown by ``health()["decode_plan"]`` and the counts;
     its decode window profiled with the attention on the kernel route and
     on the reference's gather route, in turns;
  7. Phi-3-mini's teacher-forced ``paged_step`` on the chained path, each
     call held against the plain chained pair, then on the unfused path
     (quantizer kernel → x·V in torch → GEMM kernel), the two compared;
  8. serve Phi-3-mini (phase 6's weights) with an int8 and an int4 (group
     32) KV pool: every decode step's attention through the quantized
     paged attention kernel; one decode step on the kernel route, each
     attention call held against its plain version, and its logits beside
     the gather route's;
  9. LRC calibration on the card: SmolLM-135M at full width and depth
     (random bf16 weights from seed 0, 32 x 2048 calibration tokens, the
     serving CLI's policy: rotation, GPTQ, LRC with one iteration), every
     layer's causal attention through the flash-attention kernel (30
     launches, no plain version); Update-LR must not raise the loss at any
     site; layer 0 walked again on the reference's attention route (pre_o
     within the kernel's bound, losses within ROUTE_LOSS_REL); one site of
     each weight shape solved again on the CPU in f64 (codes bitwise, U·Vᵀ
     and losses within CPU_REL); the calibrated model served as in phase 4;
     then one full-width layer of Phi-3-mini calibrated over 16 x 2048
     tokens; time per stage and peak device memory for both;
then a ``{"kernels": [...]}`` line and, last, the device line.  Without a
card, or without the repository beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): device memory and non-tensor f32
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12

# Phi-3-mini's depth served here: all of its 32 layers.  The RTN+SVD
# quantization (a float64 SVD of up to 8192 x 3072 per site, ~1 s each on
# the card) dominates the script's time; cut this first if it must shrink
PHI3_LAYERS = 32

# the chained and unfused paths' logits differ only by the order of x·V's
# f32 sums, which can flip a 4-bit code at a rounding boundary; at least
# this correlation is required of them
PATHS_MIN_CORRELATION = 0.99

SLOTS = 4          # decode rows per step (M of every decode GEMM)
PAGE = 16
CHUNK = 16         # prefill chunk (M of every prefill GEMM)
N_REQUESTS = 8
PROMPT_LEN = 12
NEW_TOKENS = 16


def phase(title):
    print(f"== {title}", flush=True)


def _kernel_modules():
    from repro_torch.kernels import actquant, flash_attn, fused_gemm, prologue, w4a4

    return (fused_gemm, prologue, w4a4, actquant, flash_attn)


def reset_launches():
    for mod in _kernel_modules():
        mod.reset_launches()


def launches():
    """Every wrapper's count: kernel launches and plain-version calls."""
    out = {}
    for mod in _kernel_modules():
        out.update(mod.LAUNCHES)
    return out


# ---------------------------------------------------------------------------
# phase 3: kernel against its plain version
# ---------------------------------------------------------------------------


def _problem(gen, m, k, n, r, x_dtype, f_dtype, device):
    import torch

    from repro_torch.core.quantizers import pack_int4

    x = torch.randn((m, k), generator=gen, device=device).to(x_dtype)
    q = torch.randint(-8, 8, (k, n), generator=gen, device=device,
                      dtype=torch.int8)
    wp = pack_int4(q.T).T.contiguous()
    sw = torch.rand((n,), generator=gen, device=device) * 0.02 + 0.001
    u = v = None
    if r:
        u = (torch.randn((n, r), generator=gen, device=device) * 0.05).to(f_dtype)
        v = (torch.randn((k, r), generator=gen, device=device) * 0.05).to(f_dtype)
    return x, v, wp, sw, u


def _tolerance(x, v, u, k, r, y_plain):
    """Elementwise bound on |kernel - plain|: only the two LR sums (K terms
    of x·V, R terms of xv·Uᵀ) are added in another order, so they may differ
    by twice the recursive-summation bound (K+R+1)·2⁻²⁴ of the sum of
    absolute terms, plus the output's final rounding."""
    import torch

    u_eps = 2.0 ** -24
    mag = y_plain.abs()
    if r:
        lr = (x.float().abs() @ v.float().abs()) @ u.float().abs().T
        mag = mag + lr
    return 2.0 * (k + r + 1) * u_eps * mag + torch.finfo(torch.float32).tiny


def _time_ms(fn, flush, reps=30, warmup=5):
    """Median device time of one call, each run after an L2 flush (the
    serving path streams ~60 MB of weights per step, more than the 50 MB
    L2, so a site's weights are cold when it runs)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        # keep the card busy while the host enqueues the call, so the events
        # time the device work and not the host's launch overhead
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _bound(nbytes, int8_ops=0, f32_ops=0):
    """Least time on an H100 SXM (ms) and what bounds it: the bytes over
    3.35 TB/s, or the int8 and f32 operations over their peak rates."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = int8_ops / INT8_OPS_PER_S + f32_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _bound_ms(m, k, n, r, x_bytes, f_bytes):
    """The fused kernel's bound: each input read once, the f32 output
    written once; the int8 GEMM plus the f32 LR products."""
    return _bound(k * n // 2 + 4 * n + f_bytes * r * (k + n) + x_bytes * m * k
                  + 4 * m * n, int8_ops=2 * m * k * n, f32_ops=2 * m * r * (k + n))


SITES = {  # SmolLM-135M's seven QLinears per layer as (K, N, R)
    "attn/wq": (576, 576, 58), "attn/wk": (576, 192, 19),
    "attn/wv": (576, 192, 19), "attn/wo": (576, 576, 58),
    "mlp/wg": (576, 1536, 58), "mlp/wu": (576, 1536, 58),
    "mlp/wd": (1536, 576, 58),
}


def phase_kernels(device):
    """Every distinct site shape at M = decode slots and M = prefill chunk,
    plus ragged cases (odd N, K not a multiple of 4 or 64, R = 0, M over
    one tile), bf16 activations and factors as served, and one f32 case."""
    import torch

    from repro_torch.kernels import fused_gemm

    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=device).manual_seed(0)
    shapes = sorted(set(SITES.values()))
    cases = [(m, k, n, r, bf16, bf16) for (k, n, r) in shapes
             for m in (SLOTS, CHUNK)]
    cases += [(17, 200, 97, 7, bf16, bf16), (3, 90, 33, 0, bf16, bf16),
              (1, 576, 577, 58, bf16, bf16), (33, 1536, 1, 5, bf16, bf16),
              (5, 256, 130, 40, f32, f32), (16, 576, 64, 58, f32, bf16)]
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=device)
    one = torch.zeros(1, device=device)
    floor = _time_ms(lambda: one.add_(1), flush)
    print(f"  timing floor (one 1-element add, same method): {floor * 1e3:.2f} us",
          flush=True)
    worst = 0.0
    timed = {}
    for (m, k, n, r, xd, fd) in cases:
        x, v, wp, sw, u = _problem(gen, m, k, n, r, xd, fd, device)
        y = fused_gemm.fused_w4a4_lrc(x, v, wp, sw, u, 4, 0.9)
        torch.cuda.synchronize()
        y_plain = fused_gemm.fused_w4a4_lrc_plain(x, v, wp, sw, u, 4, 0.9)
        tol = _tolerance(x, v, u, k, r, y_plain)
        err = (y - y_plain).abs()
        ok = bool(torch.isfinite(y).all()) and bool((err <= tol).all())
        print(f"  M={m:<3} K={k:<5} N={n:<5} R={r:<3} x={str(xd)[6:]:<8} "
              f"max_abs_err={err.max().item():.3e} "
              f"limit={tol.max().item():.3e} {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            raise SystemExit(f"kernel disagrees with its plain version at "
                             f"M={m} K={k} N={n} R={r}")
        worst = max(worst, err.max().item())
        if xd is bf16 and fd is bf16 and (k, n, r) in shapes:
            t_k = _time_ms(lambda: fused_gemm.fused_w4a4_lrc(x, v, wp, sw, u, 4, 0.9), flush)
            t_p = _time_ms(lambda: fused_gemm.fused_w4a4_lrc_plain(x, v, wp, sw, u, 4, 0.9), flush)
            b, by = _bound_ms(m, k, n, r, 2, 2)
            timed[("fused_w4a4_lrc", m, k, n, r)] = (t_k, t_p, b, by)
            print(f"    kernel {t_k * 1e3:.2f} us  plain {t_p * 1e3:.2f} us  "
                  f"bound {b * 1e3:.3f} us ({by})  library_ms null "
                  f"(no single PyTorch call computes this function)",
                  flush=True)
    return worst, timed


PHI3_SITES = {  # Phi-3-mini's seven QLinears per layer as (K, N, R)
    "attn/wq": (3072, 3072, 307), "attn/wk": (3072, 3072, 307),
    "attn/wv": (3072, 3072, 307), "attn/wo": (3072, 3072, 307),
    "mlp/wg": (3072, 8192, 307), "mlp/wu": (3072, 8192, 307),
    "mlp/wd": (8192, 3072, 307),
}


def _chain_bounds(m, k, n, r, x_bytes, f_bytes):
    """Bounds of the three chained/unfused kernels at one site: each input
    read once, each output written once."""
    prologue = _bound(x_bytes * m * k + f_bytes * k * r + m * k + 4 * m + 4 * m * r,
                      f32_ops=2 * m * k * r + 3 * m * k)
    quant = _bound(x_bytes * m * k + m * k + 4 * m, f32_ops=3 * m * k)
    gemm = _bound(m * k + 4 * m + k * n // 2 + 4 * n + 4 * m * r + f_bytes * n * r
                  + 4 * m * n, int8_ops=2 * m * k * n, f32_ops=2 * m * n * r + 2 * m * n)
    return {"fused_prologue": prologue, "act_quant": quant,
            "w4a4_lowrank_matmul": gemm}


def _xv_tolerance(x, v, k, xv_plain):
    """|kernel - plain| bound on x·V: only the order of its K-term sum
    differs, so twice the recursive-summation bound (K+1)·2⁻²⁴ of the sum
    of absolute terms, plus the final rounding."""
    import torch

    mag = x.float().abs() @ v.float().abs() + xv_plain.abs()
    return 2.0 * (k + 1) * 2.0 ** -24 * mag + torch.finfo(torch.float32).tiny


def _gemm_tolerance(xv, u, r, y_plain):
    """|kernel - plain| bound on the GEMM output: the integer part and its
    rescale are bitwise; only the R-term LR sum is ordered differently."""
    import torch

    mag = y_plain.abs()
    if r:
        mag = mag + xv.abs() @ u.float().abs().T
    return 2.0 * (r + 1) * 2.0 ** -24 * mag + torch.finfo(torch.float32).tiny


def phase_chain_kernels(device):
    """The prologue, GEMM and quantizer kernels at Phi-3-mini's three site
    shapes (M = decode slots and prefill chunk), the paper's 30 % rank
    (R = 922) and ragged cases (odd N, K % 4 == 2, K % 16 != 0, K = 16384,
    R = 0 and 1024, M over one tile, f32 operands).  Codes and scales must
    be bitwise the plain version's (and the two quantizers' the same);
    x·V and the GEMM output within their summation bounds."""
    import torch

    from repro_torch.kernels import actquant, prologue, w4a4

    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=device).manual_seed(1)
    shapes = sorted(set(PHI3_SITES.values()))
    cases = [(m, k, n, r, bf16, bf16) for (k, n, r) in shapes
             for m in (SLOTS, CHUNK)]
    cases += [(CHUNK, 3072, 3072, 922, bf16, bf16), (SLOTS, 8192, 3072, 922, bf16, bf16),
              (17, 200, 97, 7, bf16, bf16), (3, 90, 33, 0, bf16, bf16),
              (1, 3072, 3073, 307, bf16, bf16), (33, 8194, 1, 5, bf16, bf16),
              (5, 16384, 130, 40, f32, f32), (20, 1030, 64, 1024, f32, bf16)]
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=device)
    worst = {"fused_prologue": 0.0, "w4a4_lowrank_matmul": 0.0, "act_quant": 0.0}
    timed = {}
    for (m, k, n, r, xd, fd) in cases:
        x, v, wp, sw, u = _problem(gen, m, k, n, r, xd, fd, device)
        xq, sx, xv = prologue.fused_prologue(x, v, 4, 0.9)
        aq, asx = actquant.act_quant(x, 4, 0.9)
        torch.cuda.synchronize()
        xq_p, sx_p, xv_p = prologue.fused_prologue_plain(x, v, 4, 0.9)
        codes = (torch.equal(xq, xq_p) and torch.equal(sx, sx_p)
                 and torch.equal(aq, xq_p) and torch.equal(asx, sx_p))
        xv_err = xv_ok = 0.0
        if r:
            err = (xv - xv_p).abs()
            xv_ok = bool((err <= _xv_tolerance(x, v, k, xv_p)).all())
            xv_err = err.max().item()
        # the GEMM on the plain prologue's outputs, so both see one input
        y = w4a4.w4a4_lowrank_matmul(xq_p, sx_p, wp, sw, xv_p, u)
        torch.cuda.synchronize()
        y_p = w4a4.w4a4_lowrank_matmul_plain(xq_p, sx_p, wp, sw, xv_p, u)
        err = (y - y_p).abs()
        y_ok = (bool(torch.isfinite(y).all())
                and bool((err <= _gemm_tolerance(xv_p, u, r, y_p)).all()))
        ok = codes and (xv_ok or not r) and y_ok
        print(f"  M={m:<3} K={k:<5} N={n:<5} R={r:<4} x={str(xd)[6:]:<8} "
              f"codes+scales {'bitwise' if codes else 'DIFFER'}  "
              f"xv max_abs_err={xv_err:.3e}  gemm max_abs_err={err.max().item():.3e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"a chained/unfused kernel disagrees with its plain "
                             f"version at M={m} K={k} N={n} R={r}")
        worst["fused_prologue"] = max(worst["fused_prologue"], xv_err)
        worst["w4a4_lowrank_matmul"] = max(worst["w4a4_lowrank_matmul"],
                                           err.max().item())
        if (m, k, n, r, xd, fd) in cases[:2 * len(shapes)]:
            bounds = _chain_bounds(m, k, n, r, 2, 2)
            runs = {
                "fused_prologue": (lambda: prologue.fused_prologue(x, v, 4, 0.9),
                                   lambda: prologue.fused_prologue_plain(x, v, 4, 0.9)),
                "act_quant": (lambda: actquant.act_quant(x, 4, 0.9),
                              lambda: actquant.act_quant_plain(x, 4, 0.9)),
                "w4a4_lowrank_matmul": (
                    lambda: w4a4.w4a4_lowrank_matmul(xq_p, sx_p, wp, sw, xv_p, u),
                    lambda: w4a4.w4a4_lowrank_matmul_plain(xq_p, sx_p, wp, sw, xv_p, u)),
            }
            for name, (kern, plain) in runs.items():
                t_k, t_p = _time_ms(kern, flush), _time_ms(plain, flush)
                b, by = bounds[name]
                timed[(name, m, k, n, r)] = (t_k, t_p, b, by)
                print(f"    {name:<20} kernel {t_k * 1e3:8.2f} us  plain "
                      f"{t_p * 1e3:9.2f} us  bound {b * 1e3:.3f} us ({by})  "
                      f"library_ms null", flush=True)
    print("  library_ms is null for all three: no single PyTorch call computes "
          "the int4 GEMM with its rescale and LR epilogue, the quantizer, or "
          "the quantizer with x·V", flush=True)
    return worst, timed


# decode attention shapes: (batch, heads, kv heads, head_dim, page, pages per
# row, lengths).  The serve shapes are the engine's in phases 4, 6 and 8
# (SLOTS rows, max_seq 64), with one inactive row; the long one is a ragged
# Phi-3-mini batch at up to 4096 tokens.
ATTN_SHAPES = {
    "smollm-serve": (SLOTS, 9, 3, 64, PAGE, 4, (64, 37, 13, 0)),
    "phi3-serve": (SLOTS, 32, 32, 96, PAGE, 4, (64, 37, 13, 0)),
    "phi3-long": (SLOTS, 32, 32, 96, PAGE, 256, (4096, 3000, 1024, 17)),
}
ATTN_POOLS = {"paged_flash_attention": ("f32", "bf16"),
              "paged_flash_attention_quant": ("int8", "int4-g32")}


def _kv_spec(pool):
    from repro_torch.serve.kvquant import KVSpec

    dtype, _, group = pool.partition("-g")
    return KVSpec(dtype, int(group) if group else None)


def _attn_problem(shape, pool, device, seed):
    """q (bf16, as served) and a page pool holding each row's tokens on
    shuffled, disjoint pages, every other page (the null page included)
    filled with large finite garbage; returns the kernel's arguments and
    the rows' dequantized dense K/V (B, MPB·P, KH, D) f32."""
    import numpy as np
    import torch

    from repro_torch.serve.kvquant import dequantize_kv, quantize_kv

    b, h, kh, d, page, mpb, lengths = shape
    spec = _kv_spec(pool)
    gen = torch.Generator(device=device).manual_seed(seed)
    need = [-(-n // page) for n in lengths]
    n_pages = 1 + sum(need) + 8
    rng = np.random.default_rng(seed)
    ids = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((b, mpb), np.int32)
    taken = 0
    for i, n in enumerate(need):
        table[i, :n] = ids[taken:taken + n]
        taken += n
    bt = torch.from_numpy(table).to(device)
    owned = bt[bt > 0].long()
    q = torch.randn((b, h, d), generator=gen, device=device).to(torch.bfloat16)
    leaves = []
    for _ in range(2):  # k, then v
        rows = torch.randn((n_pages, page, kh, d), generator=gen, device=device)
        garbage = torch.randn((n_pages, page, kh, d), generator=gen, device=device) * 40
        if spec.is_quantized:
            codes, scales = quantize_kv(rows, spec)
            g_codes, _ = quantize_kv(garbage, spec)
            g_scales = torch.randn(scales.shape, generator=gen, device=device) * 7
            g_codes[owned], g_scales[owned] = codes[owned], scales[owned]
            leaves.append((g_codes.contiguous(), g_scales.contiguous()))
        else:
            garbage[owned] = rows[owned]
            leaves.append((garbage.to(spec.cache_dtype).contiguous(), None))
    dense = []
    for pages, scales in leaves:
        rows = pages[bt.long()]
        if spec.is_quantized:
            rows = dequantize_kv(rows, scales[bt.long()], spec, d)
        dense.append(rows.float().reshape(b, mpb * page, kh, d))
    lengths = torch.tensor(lengths, dtype=torch.int32, device=device)
    if spec.is_quantized:
        (kq, ks), (vq, vs) = leaves
        args = (q, kq, ks, vq, vs, bt, lengths, d ** -0.5, spec)
    else:
        args = (q, leaves[0][0], leaves[1][0], bt, lengths, d ** -0.5)
    return args, dense, spec, lengths


def _attn_tolerance(q, kd, vd, lengths, scale, page, y_plain):
    """Elementwise bound on |kernel - plain| for rows of non-zero length:
    the two take the same f32 steps and differ only in the order of three
    sums (the D-term score dot, the P-term Σp and p·V), so a score moves by
    at most 2·D·u·S (u = 2⁻²⁴, S the largest Σ|q·scale·k| of a valid
    token) and each sum by 2·(N + 2·pages + 4)·u relative over N tokens;
    twice both, times max |v|.  Both round their f32 result to bf16: one
    bf16 ulp of the larger side (at most 2⁻⁶ of the plain value's
    magnitude, the f32 terms being far smaller) is added."""
    import torch

    u = 2.0 ** -24
    b, h, d = q.shape
    kh = kd.shape[2]
    g = h // kh
    pos = torch.arange(kd.shape[1], device=q.device)
    valid = pos[None, :] < lengths[:, None].long()  # (B, S)
    qs = (q.float() * scale).abs().reshape(b, kh, g, d)
    s_abs = torch.einsum("bkgd,bskd->bkgs", qs, kd.abs())
    s_max = torch.where(valid[:, None, None], s_abs, 0.0).amax(-1)  # (B, KH, G)
    v_max = torch.where(valid[:, :, None, None], vd.abs(), 0.0).amax((1, 2, 3))
    n = lengths.double()
    pages = torch.ceil(n / page)
    rel = 2 * d * u * s_max.double() + (2 * (n + 2 * pages + 4) * u)[:, None, None]
    tol = (2 * v_max.double()[:, None, None] * rel).reshape(b, h, 1)
    return tol + 2.0 ** -6 * y_plain.double().abs()


def _attn_bytes(shape, spec):
    """The least bytes a call moves: every valid K and V row once (with its
    scales), q, the block table and the lengths read, the output written."""
    b, h, kh, d, page, mpb, lengths = shape
    if spec.is_quantized:
        row = spec.packed_head_dim(d) + 4 * spec.n_groups(d)
    else:
        row = {"f32": 4, "bf16": 2}[spec.dtype] * d
    return 2 * sum(lengths) * kh * row + 2 * 2 * b * h * d + 4 * b * mpb + 4 * b


def _attn_library_ms(args, dense, flush):
    """One ``scaled_dot_product_attention`` over the rows pre-gathered into
    a dense (B, H, MPB·P, D) view in the pool's dtype, masked past each
    length: the PyTorch call that computes the same function from a dense
    copy (timed as the yardstick; the port never calls it)."""
    import torch
    import torch.nn.functional as F

    q, k_pages, _, bt, lengths, scale = args
    b, h, d = q.shape
    kd, vd = dense
    g = h // kd.shape[2]
    dt = k_pages.dtype
    ql = q.to(dt)[:, :, None]
    kl, vl = (t.to(dt).permute(0, 2, 1, 3).repeat_interleave(g, dim=1).contiguous()
              for t in (kd, vd))
    mask = (torch.arange(kl.shape[2], device=q.device)[None, :]
            < lengths[:, None].long())[:, None, None]
    return _time_ms(lambda: F.scaled_dot_product_attention(
        ql, kl, vl, attn_mask=mask, scale=scale), flush)


def phase_attention_kernels(device):
    """Both paged attention kernels against their plain versions at every
    shape of ATTN_SHAPES, each pool of ATTN_POOLS, timed (median of 30, L2
    flushed), with their bytes bound and, for the float kernel, the
    library call."""
    import torch

    from repro_torch.kernels import flash_attn

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=device)
    worst = {name: 0.0 for name in ATTN_POOLS}
    timed = {}
    for name, pools in ATTN_POOLS.items():
        kern = getattr(flash_attn, name)
        plain = getattr(flash_attn, name + "_plain")
        for si, (label, shape) in enumerate(ATTN_SHAPES.items()):
            for pool in pools:
                args, dense, spec, lengths = _attn_problem(shape, pool, device,
                                                           seed=10 + si)
                y = kern(*args)
                torch.cuda.synchronize()
                y_plain = plain(*args)
                ok_rows = lengths > 0
                tol = _attn_tolerance(args[0], *dense, lengths, shape[3] ** -0.5,
                                      shape[4], y_plain)
                err = (y.double() - y_plain.double()).abs()
                ok = (bool(torch.isfinite(y[ok_rows]).all())
                      and bool((err[ok_rows] <= tol[ok_rows]).all()))
                e = err[ok_rows].max().item()
                print(f"  {name:<28} {label:<13} {pool:<9} lengths {shape[6]} "
                      f"max_abs_err={e:.3e} limit={tol[ok_rows].max().item():.3e} "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    raise SystemExit(f"{name} disagrees with its plain version at "
                                     f"{label} {pool}")
                worst[name] = max(worst[name], e)
                t_k = _time_ms(lambda: kern(*args), flush)
                t_p = _time_ms(lambda: plain(*args), flush)
                b_ms, by = _bound(_attn_bytes(shape, spec),
                                  f32_ops=4 * sum(shape[6]) * shape[1] * shape[3])
                t_l = None if spec.is_quantized else _attn_library_ms(args, dense, flush)
                timed[(name, label, pool)] = (t_k, t_p, b_ms, by, t_l)
                print(f"    kernel {t_k * 1e3:9.2f} us  plain {t_p * 1e3:10.2f} us  "
                      f"bound {b_ms * 1e3:8.3f} us ({by})  library "
                      + ("null (no PyTorch call attends over a quantized pool)"
                         if t_l is None else f"{t_l * 1e3:.2f} us (SDPA, dense view)"),
                      flush=True)
                del args, dense, y, y_plain
    return worst, timed


# dense causal attention shapes (batch, seq, heads, kv heads, head_dim,
# dtype): the SmolLM-135M calibration walk of phase 9 (32 x 2048 tokens),
# Phi-3-mini's heads at 4 x 2048, a ragged S and S = 1
FLASH_SHAPES = {
    "smollm-calib": (32, 2048, 9, 3, 64, "float32"),
    "phi3-f32": (4, 2048, 32, 32, 96, "float32"),
    "phi3-bf16": (4, 2048, 32, 32, 96, "bfloat16"),
    "ragged-200": (3, 200, 9, 3, 64, "float32"),
    "ragged-200-bf16": (2, 200, 32, 32, 96, "bfloat16"),
    "s1": (4, 1, 32, 32, 96, "bfloat16"),
}


def _flash_tolerance(q, k, v, scale, y_plain):
    """Elementwise bound on |kernel - plain| of dense causal attention: the
    two take the same f32 steps on the same 128-row key tiles and differ
    only in the order of three sums, so a score moves by at most 2·D·u·S
    (u = 2⁻²⁴, S = Σ_d |q_d·scale|·max_keys |k_d| >= the row's largest
    Σ|q·scale·k|) and each of the row's sums by 2·(N + 2·tiles + 4)·u
    relative over its N = qpos + 1 keys; twice both, times max |v| of the
    kv head.  A bf16 output adds one bf16 ulp of the larger side (at most
    2⁻⁶ of the plain value's magnitude)."""
    import torch

    u = 2.0 ** -24
    b, sq, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    f64 = torch.float64
    kmax = k.double().abs().amax(dim=1)  # (B, KH, D)
    qs = (q.double() * scale).abs().reshape(b, sq, kh, g, d)
    s_max = torch.einsum("bskgd,bkd->bskg", qs, kmax).reshape(b, sq, h)
    vmax = v.double().abs().amax(dim=(1, 3))  # (B, KH)
    vmax = vmax.repeat_interleave(g, dim=1)[:, None, :]  # (B, 1, H)
    n = torch.arange(1, sq + 1, dtype=f64, device=q.device)[None, :, None]
    tiles = torch.ceil(n / 128)
    rel = 2 * d * u * s_max + 2 * (n + 2 * tiles + 4) * u
    tol = (2 * vmax * rel)[..., None]
    if y_plain.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -6 * y_plain.double().abs()
    return tol


def _flash_bound(shape):
    """Least time of one causal call on an H100 SXM (ms) and what bounds it:
    q, k, v and the output moved once each, or the 4·B·H·D·S(S+1)/2 f32
    operations of the causal product at the non-tensor f32 rate."""
    b, s, h, kh, d, dtype = shape
    item = 4 if dtype == "float32" else 2
    nbytes = item * b * s * d * (2 * h + 2 * kh)
    return _bound(nbytes, f32_ops=4 * b * h * d * s * (s + 1) // 2)


def phase_flash_kernels(device):
    """The dense causal flash-attention kernel against its plain version at
    every shape of FLASH_SHAPES, timed (median of 30, L2 flushed) beside
    its bound and ``scaled_dot_product_attention(is_causal=True)`` on an
    expanded-KV copy (the copy made outside the timing)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attn

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=device)
    gen = torch.Generator(device=device).manual_seed(3)
    worst, timed = 0.0, {}
    for label, shape in FLASH_SHAPES.items():
        b, s, h, kh, d, dtype = shape
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn((b, s, heads, d), generator=gen, device=device).to(dt)
                   for heads in (h, kh, kh))
        scale = d ** -0.5
        y = flash_attn.flash_attention(q, k, v, scale)
        torch.cuda.synchronize()
        y_plain = flash_attn.flash_attention_plain(q, k, v, scale)
        tol = _flash_tolerance(q, k, v, scale, y_plain)
        err = (y.double() - y_plain.double()).abs()
        ok = bool(torch.isfinite(y).all()) and bool((err <= tol).all())
        e = err.max().item()
        print(f"  flash_attention {label:<16} B={b} S={s} H={h} KH={kh} D={d} {dtype:<8} "
              f"max_abs_err={e:.3e} limit(min)={tol.min().item():.3e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"flash_attention disagrees with its plain version at {label}")
        worst = max(worst, e)
        t_k = _time_ms(lambda: flash_attn.flash_attention(q, k, v, scale), flush)
        t_p = _time_ms(lambda: flash_attn.flash_attention_plain(q, k, v, scale), flush)
        ql, kl, vl = (t.transpose(1, 2).repeat_interleave(h // t.shape[2], dim=1)
                      .contiguous() for t in (q, k, v))
        t_l = _time_ms(lambda: F.scaled_dot_product_attention(
            ql, kl, vl, is_causal=True, scale=scale), flush)
        del ql, kl, vl
        b_ms, by = _flash_bound(shape)
        timed[label] = (t_k, t_p, b_ms, by, t_l)
        print(f"    kernel {t_k * 1e3:10.2f} us  plain {t_p * 1e3:11.2f} us  bound "
              f"{b_ms * 1e3:9.2f} us ({by})  library {t_l * 1e3:9.2f} us (SDPA, "
              f"is_causal, expanded KV)", flush=True)
        del q, k, v, y, y_plain, tol, err
    return worst, timed


# ---------------------------------------------------------------------------
# phases 4-7: serve end to end, teacher-forced parity
# ---------------------------------------------------------------------------


def build_model(device, arch="smollm-135m", n_layers=None):
    """``arch`` at full width (its first ``n_layers`` layers if given), bf16,
    random weights from seed 0, every linear W4A4+LRC by RTN + SVD at
    rank_frac 0.10, clip 0.9."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model
    from repro_torch.quant.calibrate import quantize_model
    from repro_torch.quant.policy import QuantPolicy

    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    t0 = time.perf_counter()
    params = model.init_params(cfg, seed=0, device=device)
    policy = QuantPolicy(quant_method="rtn", correction="svd", rank_frac=0.10,
                         clip_ratio=0.9)
    qparams = quantize_model(cfg, params, None, policy, rotate=False)
    torch.cuda.synchronize()
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}; RTN+SVD quantized in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return cfg, qparams


def phase_serve(cfg, qparams, device, kernels, kv_spec=None, route_ab=False):
    """Serve the traffic through ``ServeEngine.submit``/``run`` with a KV
    pool of ``kv_spec`` (None: f32); every QLinear call must launch each
    kernel named in ``kernels`` once, every decode step's attention the
    spec's paged attention kernel once per layer, and no other kernel or
    plain version may run.  ``route_ab`` adds :func:`profile_routes`."""
    import numpy as np
    import torch

    from repro_torch.serve.engine import Request, RequestState, ServeEngine

    def engine():
        return ServeEngine(cfg, qparams, batch_slots=SLOTS, max_seq=64,
                           page_size=PAGE, prefill_chunk=CHUNK, device=device,
                           kv_spec=kv_spec)

    def prompts():  # as launch/serve.py makes them
        rng = np.random.default_rng(0)
        return [rng.integers(0, cfg.vocab_size, PROMPT_LEN).astype(np.int32)
                for _ in range(N_REQUESTS)]

    warm = engine()  # first-use costs (cuBLAS handles, allocator) out of the timing
    warm.submit(Request(rid=0, prompt=prompts()[0], max_new_tokens=2))
    warm.run()

    eng = engine()
    times = {"prefill": [], "decode": []}
    inner = eng._paged

    def timed(params, tokens, *rest):
        t = time.perf_counter()
        out = inner(params, tokens, *rest)
        torch.cuda.synchronize()
        kind = "decode" if tokens.shape == (SLOTS, 1) else "prefill"
        times[kind].append(time.perf_counter() - t)
        return out

    eng._paged = timed
    for i, p in enumerate(prompts()):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS))
    reset_launches()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()

    bad = [r for r, rec in done.items()
           if rec.status is not RequestState.FINISHED or rec.new_tokens != NEW_TOKENS]
    if len(done) != N_REQUESTS or bad:
        raise SystemExit(f"serve: requests {bad} did not finish with "
                         f"{NEW_TOKENS} tokens: {done}")
    calls = eng.counters["decode_calls"] + eng.counters["prefill_calls"]
    want = 7 * cfg.n_layers * calls
    health = eng.health()
    attn = health["decode_attention"]["kernel"]
    want_attn = cfg.n_layers * eng.counters["decode_calls"]
    expected = {name: want if name in kernels else 0 for name in counts}
    expected[attn] = want_attn
    print(f"  {N_REQUESTS} requests x {NEW_TOKENS} tokens finished; counters "
          f"{eng.counters}", flush=True)
    for site in health["decode_plan"]:
        print(f"  decode_plan: {site}", flush=True)
    print(f"  decode_attention: {health['decode_attention']}; kv: {health['kv']}",
          flush=True)
    print(f"  model calls {calls}: launches {counts} (want 7 x {cfg.n_layers} "
          f"x {calls} = {want} for {kernels}, {cfg.n_layers} x "
          f"{eng.counters['decode_calls']} decode calls = {want_attn} for {attn}, "
          f"0 for the rest)", flush=True)
    if counts != expected:
        raise SystemExit(f"serve: not every QLinear went through {kernels}, or "
                         f"not every decode attention through {attn}")
    n_tok = sum(rec.new_tokens for rec in done.values())
    prof = profile_decode(cfg, qparams, device, engine, prompts())
    if route_ab:
        prof["routes"] = profile_routes(cfg, qparams, device, prompts(), kv_spec)
    stats = {
        "tokens_per_s": n_tok / wall,
        "wall_s": wall,
        "decode_step_ms": statistics.median(times["decode"]) * 1e3,
        "prefill_chunk_ms": statistics.median(times["prefill"]) * 1e3,
        "decode_calls": eng.counters["decode_calls"],
        "prefill_calls": eng.counters["prefill_calls"],
        "kv": health["kv"],
        **prof,
    }
    print(f"  {n_tok} tokens in {wall:.3f} s = {stats['tokens_per_s']:.1f} tok/s; "
          f"decode step {stats['decode_step_ms']:.2f} ms (median of "
          f"{len(times['decode'])}); prefill chunk {stats['prefill_chunk_ms']:.2f} "
          f"ms (median of {len(times['prefill'])})", flush=True)
    return counts, stats


def profile_decode(cfg, qparams, device, engine, prompts, top=10):
    """Where a decode step's time goes: one decode-only window (SLOTS
    requests already prefilled) under torch.profiler — device time by
    kernel (the ``top`` largest printed), and the share of the window the
    card was idle.  Only the device's own events (kernels, memsets,
    copies) are summed: a CPU operator's row repeats the device time of the
    kernels it launched, as torch's own table total leaves it out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import Request

    eng = engine()
    for i, p in enumerate(prompts[:SLOTS]):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS))
    eng._admit()  # prefill every slot; the window below only decodes
    steps = 4
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng._step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA or getattr(evt, "is_user_annotation", False):
            continue
        if evt.self_device_time_total > 0:
            rows.append((evt.self_device_time_total, evt.key, evt.count))
    if not rows:
        raise SystemExit("profile: torch.profiler recorded no device time")
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    print(f"  profile: {steps} decode steps in {wall * 1e3:.2f} ms wall, device "
          f"busy {busy * 1e3:.2f} ms ({busy / wall:.1%}), idle {1 - busy / wall:.1%}",
          flush=True)
    for dev_us, key, count in rows[:top]:
        print(f"    {dev_us / steps / 1e3:8.3f} ms/step  x{count // steps:<5} {key[:90]}",
              flush=True)
    return {"profiled_step_ms": wall / steps * 1e3,
            "device_busy_ms_per_step": busy / steps * 1e3,
            "device_idle_share": 1 - busy / wall}


def profile_routes(cfg, qparams, device, prompts, kv_spec=None):
    """The decode window of :func:`profile_decode` with every decode step's
    attention on the kernel route and on the reference's gather route, in
    turns (kernel, gather, gather, kernel) within this one call: what the
    kernel took off the step.  Returns the mean of each route's two
    windows."""
    from repro_torch.kernels.context import KernelContext
    from repro_torch.serve.engine import ServeEngine

    runs = {"kernel": [], "gather": []}
    for route in ("kernel", "gather", "gather", "kernel"):
        def engine():
            return ServeEngine(cfg, qparams, batch_slots=SLOTS, max_seq=64,
                               page_size=PAGE, prefill_chunk=CHUNK, device=device,
                               kv_spec=kv_spec, ctx=KernelContext(attention=route))
        print(f"  route {route}:", flush=True)
        runs[route].append(profile_decode(cfg, qparams, device, engine, prompts, top=3))
    return {route: {k: statistics.mean(r[k] for r in rs) for k in rs[0]}
            for route, rs in runs.items()}


def phase_parity(cfg, qparams, device):
    """One teacher-forced paged_step over SLOTS x CHUNK tokens of the served
    model through the kernel path.

    (a) Every one of its 7 x 30 QLinear calls is held against the kernel's
        plain version on the same activations, to the phase-3 tolerance.
    (b) Its logits are compared with the plain ``int8`` impl's (and, as the
        yardstick, ``sim``'s with ``int8``'s).  These differ by design:
        ``int8`` and ``sim`` quantize bf16 activations with bf16 scales and
        multiply the LR term in bf16 where the kernel works in f32, and on a
        random 30-layer bf16 model a 4-bit code that flips at a rounding
        boundary carries any such difference to the logits; so does the
        kernel's own summation order (printed as kernel~plain).  The logits
        are held to being finite and to the agreement of the two plain
        impls: corr(kernel, int8) >= corr(sim, int8) - 0.05."""
    import numpy as np
    import torch

    from repro_torch.kernels import fused_gemm, ops
    from repro_torch.models import model
    from repro_torch.quant.qlinear import retag_qlinear_impl

    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (SLOTS, CHUNK))).to(device)
    positions = torch.arange(CHUNK, device=device).expand(SLOTS, CHUNK)
    valid = torch.ones((SLOTS, CHUNK), dtype=torch.bool, device=device)
    per = -(-CHUNK // PAGE)
    block_table = (1 + torch.arange(SLOTS * per, device=device)).reshape(SLOTS, per)

    def logits_of(impl):
        pool = model.init_paged_cache(cfg, 1 + SLOTS * per, PAGE,
                                      dtype=torch.float32, device=device)
        out, _ = model.paged_step(
            cfg, retag_qlinear_impl(qparams, impl), tokens, positions, valid,
            pool, block_table)
        out = out.flatten()
        if not torch.isfinite(out).all():
            raise SystemExit(f"parity: non-finite logits from {impl}")
        return out

    site = {"calls": 0, "worst": 0.0, "bad": 0}

    def checked(x, v, wp, sw, u, bits=4, clip_ratio=1.0):
        y = fused_gemm.fused_w4a4_lrc(x, v, wp, sw, u, bits, clip_ratio)
        yp = fused_gemm.fused_w4a4_lrc_plain(x, v, wp, sw, u, bits, clip_ratio)
        err = (y - yp).abs()
        tol = _tolerance(x, v, u, x.shape[1], 0 if v is None else v.shape[1], yp)
        site["calls"] += 1
        site["worst"] = max(site["worst"], err.max().item())
        site["bad"] += int(not bool((err <= tol).all()))
        return y

    ops.fused_w4a4_lrc = checked
    try:
        kernel = logits_of("pallas")
        ops.fused_w4a4_lrc = fused_gemm.fused_w4a4_lrc_plain
        plain = logits_of("pallas")
    finally:
        ops.fused_w4a4_lrc = fused_gemm.fused_w4a4_lrc
    print(f"  (a) {site['calls']} QLinear calls on the served activations: max "
          f"|kernel - plain| {site['worst']:.3e}, {site['bad']} outside the "
          f"tolerance", flush=True)
    if site["calls"] != 7 * cfg.n_layers or site["bad"]:
        raise SystemExit("parity: a QLinear call disagrees with the plain version")

    int8, sim = logits_of("int8"), logits_of("sim")

    def corr(a, b):
        return torch.corrcoef(torch.stack([a, b]))[0, 1].item()

    rows = {"kernel~int8": (kernel, int8), "sim~int8": (sim, int8),
            "kernel~plain": (kernel, plain)}
    stats = {"site_max_abs_err": site["worst"]}
    for name, (a, b) in rows.items():
        c, d = corr(a, b), (a - b).abs().max().item()
        stats[name] = {"correlation": c, "max_abs_diff": d}
        print(f"  (b) logits {name:<13} correlation {c:.6f}  max |diff| {d:.4e}",
              flush=True)
    floor = stats["sim~int8"]["correlation"] - 0.05
    if stats["kernel~int8"]["correlation"] < floor:
        raise SystemExit(f"parity: kernel path correlates with int8 below {floor:.3f}")
    return stats


def phase_paths(cfg, qparams, device):
    """One teacher-forced paged_step over SLOTS x CHUNK tokens of the served
    Phi-3-mini, first with every QLinear pinned to the chained path, then to
    the unfused one.

    (a) chained: each QLinear call's prologue is held against the plain
        prologue (codes and scales bitwise, x·V within its bound) and its
        GEMM against the plain GEMM on the same inputs.
    (b) unfused: each call's quantizer is held bitwise against the plain
        one and its GEMM as in (a); the quantizer launches 7 x layers times.
    (c) logits: finite from both paths; the paths differ only in the order
        of x·V's sums, so their logits must correlate to at least
        PATHS_MIN_CORRELATION (the all-plain chained path is printed beside
        them as the yardstick)."""
    import numpy as np
    import torch

    from repro_torch.kernels import actquant, ops, prologue, w4a4
    from repro_torch.kernels.context import KernelContext
    from repro_torch.models import model
    from repro_torch.quant.qlinear import retag_qlinear_impl

    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (SLOTS, CHUNK))).to(device)
    positions = torch.arange(CHUNK, device=device).expand(SLOTS, CHUNK)
    valid = torch.ones((SLOTS, CHUNK), dtype=torch.bool, device=device)
    per = -(-CHUNK // PAGE)
    block_table = (1 + torch.arange(SLOTS * per, device=device)).reshape(SLOTS, per)

    def logits_of(path):
        pool = model.init_paged_cache(cfg, 1 + SLOTS * per, PAGE,
                                      dtype=torch.float32, device=device)
        params = retag_qlinear_impl(qparams, "pallas",
                                    ctx=KernelContext(impl=path))
        out, _ = model.paged_step(cfg, params, tokens, positions, valid, pool,
                                  block_table)
        out = out.flatten()
        if not torch.isfinite(out).all():
            raise SystemExit(f"paths: non-finite logits from the {path} path")
        return out

    site = {"calls": 0, "xv": 0.0, "gemm": 0.0, "bad": 0}

    def checked_prologue(x, v, bits=4, clip_ratio=1.0):
        xq, sx, xv = prologue.fused_prologue(x, v, bits, clip_ratio)
        xq_p, sx_p, xv_p = prologue.fused_prologue_plain(x, v, bits, clip_ratio)
        site["calls"] += 1
        bad = not (torch.equal(xq, xq_p) and torch.equal(sx, sx_p))
        if v is not None:
            err = (xv - xv_p).abs()
            site["xv"] = max(site["xv"], err.max().item())
            bad |= not bool((err <= _xv_tolerance(x, v, x.shape[1], xv_p)).all())
        site["bad"] += int(bad)
        return xq, sx, xv

    def checked_quant(x, bits=4, clip_ratio=1.0):
        xq, sx = actquant.act_quant(x, bits, clip_ratio)
        xq_p, sx_p = actquant.act_quant_plain(x, bits, clip_ratio)
        site["calls"] += 1
        site["bad"] += int(not (torch.equal(xq, xq_p) and torch.equal(sx, sx_p)))
        return xq, sx

    def checked_gemm(xq, sx, wp, sw, xv=None, u=None):
        y = w4a4.w4a4_lowrank_matmul(xq, sx, wp, sw, xv, u)
        y_p = w4a4.w4a4_lowrank_matmul_plain(xq, sx, wp, sw, xv, u)
        err = (y - y_p).abs()
        r = 0 if xv is None else xv.shape[1]
        site["gemm"] = max(site["gemm"], err.max().item())
        site["bad"] += int(not bool((err <= _gemm_tolerance(xv, u, r, y_p)).all()))
        return y

    n_sites = 7 * cfg.n_layers
    out, counts, errs = {}, {}, {}
    for path in ("chained", "unfused"):
        site.update(calls=0, bad=0, xv=0.0, gemm=0.0)
        ops.fused_prologue, ops.act_quant = checked_prologue, checked_quant
        ops.w4a4_lowrank_matmul = checked_gemm
        reset_launches()
        try:
            out[path] = logits_of(path)
            torch.cuda.synchronize()
        finally:
            ops.fused_prologue, ops.act_quant = prologue.fused_prologue, actquant.act_quant
            ops.w4a4_lowrank_matmul = w4a4.w4a4_lowrank_matmul
        counts[path] = {k: c for k, c in launches().items() if not k.endswith("_plain")}
        errs[path] = {"xv": site["xv"], "gemm": site["gemm"]}
        first = "fused_prologue" if path == "chained" else "act_quant"
        want = {k: n_sites if k in (first, "w4a4_lowrank_matmul") else 0
                for k in counts[path]}
        print(f"  ({'a' if path == 'chained' else 'b'}) {path}: {site['calls']} "
              f"QLinear calls, max |kernel - plain| x·V {site['xv']:.3e} (chained "
              f"only), GEMM "
              f"{site['gemm']:.3e}; {site['bad']} outside the tolerance; "
              f"kernel launches {counts[path]}", flush=True)
        if site["calls"] != n_sites or site["bad"] or counts[path] != want:
            raise SystemExit(f"paths: the {path} path's kernels disagree with "
                             f"their plain versions or were not all launched")
    ops.fused_prologue = prologue.fused_prologue_plain
    ops.w4a4_lowrank_matmul = w4a4.w4a4_lowrank_matmul_plain
    try:
        out["plain"] = logits_of("chained")
    finally:
        ops.fused_prologue = prologue.fused_prologue
        ops.w4a4_lowrank_matmul = w4a4.w4a4_lowrank_matmul

    def corr(a, b):
        return torch.corrcoef(torch.stack([a, b]))[0, 1].item()

    stats = {"act_quant_launches": counts["unfused"]["act_quant"],
             "site_max_abs_err": errs}
    for a, b in (("chained", "unfused"), ("chained", "plain")):
        c, d = corr(out[a], out[b]), (out[a] - out[b]).abs().max().item()
        stats[f"{a}~{b}"] = {"correlation": c, "max_abs_diff": d}
        print(f"  (c) logits {a}~{b:<8} correlation {c:.6f}  max |diff| {d:.4e}",
              flush=True)
    if stats["chained~unfused"]["correlation"] < PATHS_MIN_CORRELATION:
        raise SystemExit("paths: chained and unfused logits disagree")
    return stats


def phase_kv_routes(cfg, qparams, device, spec):
    """One teacher-forced decode step of the served model over a ``spec``
    pool that a gather-route prefill of SLOTS x CHUNK tokens filled, on
    the kernel route (each attention call held against its plain version
    on the same operands, to the phase-3 bound) and on the gather route
    (the reference's bf16 gather and attention).  The two routes' logits
    differ by the gather route's bf16 roundings, which the random W4A4
    model carries through its 4-bit codes, so their correlation is printed
    beside the per-call check, which is the gate; both must be finite."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attn, ops
    from repro_torch.kernels.context import KernelContext
    from repro_torch.models import model
    from repro_torch.quant.qlinear import retag_qlinear_impl
    from repro_torch.serve.kvquant import dequantize_kv

    params = retag_qlinear_impl(qparams, "pallas")
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (SLOTS, CHUNK + 1))).to(device)
    per = -(-(CHUNK + 1) // PAGE)
    block_table = (1 + torch.arange(SLOTS * per, device=device)).reshape(SLOTS, per)
    pool = model.init_paged_cache(cfg, 1 + SLOTS * per, PAGE, device=device,
                                  kv_spec=spec)
    gather = KernelContext(attention="gather")
    model.paged_step(cfg, params, tokens[:, :CHUNK],
                     torch.arange(CHUNK, device=device).expand(SLOTS, CHUNK),
                     torch.ones((SLOTS, CHUNK), dtype=torch.bool, device=device),
                     pool, block_table, kv_spec=spec, ctx=gather)
    site = {"calls": 0, "worst": 0.0, "bad": 0}

    def checked(q, kp, ks, vp, vs, bt, lengths, scale, kv_spec):
        y = flash_attn.paged_flash_attention_quant(q, kp, ks, vp, vs, bt, lengths,
                                                   scale, kv_spec)
        y_p = flash_attn.paged_flash_attention_quant_plain(q, kp, ks, vp, vs, bt,
                                                           lengths, scale, kv_spec)
        d = q.shape[-1]
        dense = [dequantize_kv(p[bt.long()], s[bt.long()], kv_spec, d)
                 .reshape(q.shape[0], -1, p.shape[2], d) for p, s in ((kp, ks), (vp, vs))]
        tol = _attn_tolerance(q, *dense, lengths, scale, kp.shape[1], y_p)
        err = (y.double() - y_p.double()).abs()
        site["calls"] += 1
        site["worst"] = max(site["worst"], err.max().item())
        site["bad"] += int(not bool((err <= tol).all()))
        return y

    out = {}
    step = (tokens[:, CHUNK:], torch.full((SLOTS, 1), CHUNK, device=device),
            torch.ones((SLOTS, 1), dtype=torch.bool, device=device))
    ops.paged_flash_attention_quant = checked
    try:
        for route in ("kernel", "gather"):
            fresh = {k: v.clone() for k, v in pool.items()}
            logits, _ = model.paged_step(cfg, params, *step, fresh, block_table,
                                         kv_spec=spec, ctx=KernelContext(attention=route))
            out[route] = logits.flatten()
            if not torch.isfinite(out[route]).all():
                raise SystemExit(f"kv routes: non-finite logits on the {route} route")
    finally:
        ops.paged_flash_attention_quant = flash_attn.paged_flash_attention_quant
    c = torch.corrcoef(torch.stack([out["kernel"], out["gather"]]))[0, 1].item()
    d = (out["kernel"] - out["gather"]).abs().max().item()
    print(f"  {spec.describe()}: {site['calls']} attention calls on the kernel route, "
          f"max |kernel - plain| {site['worst']:.3e}, {site['bad']} outside the bound; "
          f"logits kernel~gather route correlation {c:.6f}, max |diff| {d:.4e}",
          flush=True)
    if site["calls"] != cfg.n_layers or site["bad"]:
        raise SystemExit(f"kv routes: a {spec.describe()} attention call disagrees "
                         f"with its plain version, or not every layer ran one")
    return {"site_max_abs_err": site["worst"], "kernel~gather": {
        "correlation": c, "max_abs_diff": d}}


# ---------------------------------------------------------------------------
# phase 9: LRC calibration on the card
# ---------------------------------------------------------------------------

# the serving CLI's calibration policy: GPTQ + LRC (1 iteration), rotation
CALIB_POLICY = dict(rank_frac=0.10, impl="sim", clip_ratio=0.9)
# the paper's sequence length; a quarter of its 128 sequences (SmolLM), an
# eighth for Phi-3-mini's one layer
CALIB_SEQ_LEN = 2048
SMOL_CALIB_SEQS = 32
PHI3_CALIB_SEQS = 16
# layer 0's losses on the kernel and the reference attention route, as a
# fraction of each site's output power ||W X||²/n: the routes' pre_o differ
# within the kernel's f32 bound (~1e-6), which flips the odd 4-bit
# activation code of the statistics Σy and the odd GPTQ code; a loss is a
# difference of trace terms of the order of the output power, so it moves
# by that change of the statistics times the output power, not times
# itself (the loss is ~1-2 % of the power; on an H100 layer 0's mlp/wd
# moved by 1.7e-3 of its loss, 3e-5 of its power)
ROUTE_LOSS_REL = 1e-3
# one site per shape class solved on the card and on this machine's CPU, f64
CPU_REL = 1e-8


class StageTimes:
    """Seconds per calibration stage, read by wrapping the functions the
    walk calls (each wrapped call synchronizes the card before and after,
    so the stages do not overlap): the rotation, the statistics, GPTQ,
    ``lrc_solve`` (whose time less GPTQ's is the eigensolves and triangular
    solves), the walk's attention, and the time at the end of each layer.
    Each LRC solve's result is kept (``lrc``: name, result), and for each
    weight shape of layer 0 its first site's weight and statistics
    (``sites``: shape → (name, w, stats))."""

    def __init__(self):
        self.sec = {"rotation": 0.0, "statistics": 0.0, "gptq": 0.0,
                    "lrc_solve": 0.0, "attention": 0.0}
        self.layers, self.lrc, self.sites = [], [], {}
        self.rotated = None
        self._names = []

    def _timed(self, stage, fn):
        import torch

        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.sec[stage] += time.perf_counter() - t
            return out
        return wrapped

    def run(self, cfg, params, tokens, policy):
        import torch

        from repro_torch.core import lrc
        from repro_torch.quant import calibrate

        orig = {"rotate_model": calibrate.rotate_model,
                "collect_stats": calibrate.collect_stats,
                "lrc_solve": calibrate.lrc_solve,
                "causal_attention": calibrate.causal_attention,
                "solve_site": calibrate.solve_site,
                "gptq_quantize": lrc.gptq_quantize}

        def rotate(*a, **kw):
            self.rotated = orig["rotate_model"](*a, **kw)
            return self.rotated

        def solve(w, st, pol, pre_rot=False, name=None):
            self._names.append(name)
            if not self.layers and tuple(w.shape) not in self.sites:
                self.sites[tuple(w.shape)] = (name, w, st)
            return orig["solve_site"](w, st, pol, pre_rot, name)

        def solve_lrc(*a, **kw):
            res = orig["lrc_solve"](*a, **kw)
            self.lrc.append((self._names[-1], res))
            return res

        calibrate.rotate_model = self._timed("rotation", rotate)
        calibrate.collect_stats = self._timed("statistics", orig["collect_stats"])
        calibrate.lrc_solve = self._timed("lrc_solve", solve_lrc)
        calibrate.causal_attention = self._timed("attention", orig["causal_attention"])
        calibrate.solve_site = solve
        lrc.gptq_quantize = self._timed("gptq", orig["gptq_quantize"])
        t0 = time.perf_counter()

        def progress(layer, n_layers):
            torch.cuda.synchronize()
            self.layers.append(time.perf_counter() - t0)

        try:
            torch.cuda.reset_peak_memory_stats()
            out = calibrate.quantize_model(cfg, params, tokens, policy,
                                           progress=progress)
            torch.cuda.synchronize()
        finally:
            calibrate.rotate_model = orig["rotate_model"]
            calibrate.collect_stats = orig["collect_stats"]
            calibrate.lrc_solve = orig["lrc_solve"]
            calibrate.causal_attention = orig["causal_attention"]
            calibrate.solve_site = orig["solve_site"]
            lrc.gptq_quantize = orig["gptq_quantize"]
        self.total = time.perf_counter() - t0
        self.peak_gb = torch.cuda.max_memory_allocated() / 1e9
        return out

    def summary(self):
        per_layer = [b - a for a, b in zip([0.0] + self.layers, self.layers)]
        return {"total_s": self.total, "rotation_s": self.sec["rotation"],
                "statistics_s": self.sec["statistics"], "gptq_s": self.sec["gptq"],
                "eigh_and_solves_s": self.sec["lrc_solve"] - self.sec["gptq"],
                "walk_attention_s": self.sec["attention"],
                "per_layer_s": per_layer, "peak_gb": self.peak_gb}


def _print_times(label, times):
    per = times["per_layer_s"]
    print(f"  {label}: total {times['total_s']:.2f} s; rotation "
          f"{times['rotation_s']:.3f} s, statistics {times['statistics_s']:.2f} s, "
          f"GPTQ {times['gptq_s']:.2f} s, eigh/solves "
          f"{times['eigh_and_solves_s']:.2f} s, walk attention "
          f"{times['walk_attention_s']:.3f} s; per layer median "
          f"{statistics.median(per):.3f} s (first {per[0]:.3f}, max {max(per):.3f}); "
          f"max_memory_allocated {times['peak_gb']:.2f} GB", flush=True)


def _check_update_lr(stage):
    """Prop 3.3 at every site: Update-LR does not raise the loss."""
    bad = [(name, r.losses) for name, r in stage.lrc
           if not all(r.losses[i + 1] <= r.losses[i] * (1 + 1e-9)
                      for i in range(0, len(r.losses), 2))]
    if bad:
        raise SystemExit(f"calibration: Update-LR raised the loss at {bad}")


def _layer0_routes(cfg, stage, tokens, policy, device):
    """Layer 0 walked again on the reference's attention route: its pre_o
    against the kernel on the same q, k, v (within the kernel's f32 bound
    against ``attention``: ``_flash_tolerance`` with the one extra rounding
    of the reference's scale-after-product), and its seven sites' losses
    against the kernel-route walk's (within ROUTE_LOSS_REL of the site's
    output power)."""
    import torch

    from repro_torch.core.lrc import reconstruction_loss
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import embed_tokens
    from repro_torch.quant import calibrate

    rotated = stage.rotated
    x = embed_tokens(cfg, rotated, tokens).to(torch.float32)
    b, s, _ = x.shape
    positions = torch.arange(s, device=device).expand(b, s)
    seen, results, power = [], [], []
    orig_attn, orig_lrc = calibrate.causal_attention, calibrate.lrc_solve

    def capture(q, k, v, scale, route, mask=None):
        out = orig_attn(q, k, v, scale, route, mask)
        seen.append((q, k, v, scale, out))
        return out

    def solve_lrc(w, st, *a, **kw):
        res = orig_lrc(w, st, *a, **kw)
        results.append(res)
        power.append(reconstruction_loss(w, st))
        return res

    calibrate.causal_attention, calibrate.lrc_solve = capture, solve_lrc
    try:
        calibrate._dense_layer_walk(cfg, rotated["layers"][0], x, positions, None,
                                    policy, route="gather")
    finally:
        calibrate.causal_attention, calibrate.lrc_solve = orig_attn, orig_lrc
    del x
    q, k, v, scale, ref = seen[0]
    kern = ops.flash_attention(q, k, v, scale)
    torch.cuda.synchronize()
    tol = _flash_tolerance(q, k, v, scale, ref)
    # one more rounding per score on the reference's side (scale after the dot)
    tol = tol * (q.shape[-1] + 1) / q.shape[-1]
    err = (kern.double() - ref.double()).abs()
    pre_o_ok = bool((err <= tol).all())
    sites = {}
    for (name, rk), rr, p in zip(stage.lrc[:7], results, power):
        diff = max(abs(a - b) for a, b in zip(rk.losses, rr.losses))
        sites[name] = {"of_loss": diff / min(rr.losses), "of_power": diff / p,
                       "loss_over_power": rr.losses[-1] / p}
    worst = max(v["of_power"] for v in sites.values())
    print(f"  layer 0, kernel vs reference attention route: pre_o max |diff| "
          f"{err.max().item():.3e} (bound min {tol.min().item():.3e}) "
          f"{'ok' if pre_o_ok else 'FAIL'}; site losses max |diff| {worst:.3e} of "
          f"the output power (limit {ROUTE_LOSS_REL})", flush=True)
    for name, v in sites.items():
        print(f"    {name}: |diff| {v['of_loss']:.3e} of the loss, {v['of_power']:.3e} "
              f"of the output power; loss/power {v['loss_over_power']:.4f}", flush=True)
    if not pre_o_ok or len(results) != 7 or worst > ROUTE_LOSS_REL:
        raise SystemExit("calibration: the kernel route's layer 0 disagrees with the "
                         "reference route")
    return {"pre_o_max_abs_diff": err.max().item(), "sites": sites}


def _card_vs_cpu(stage, policy):
    """One layer-0 site of each weight shape solved again on this
    machine's CPU in f64 from the card's statistics: codes and scales
    bitwise, U Vᵀ and the losses within CPU_REL (U Vᵀ also within the f32
    rounding of the factors, 2·2⁻²⁴·|U||V|ᵀ)."""
    import torch

    from repro_torch.core.lrc import lrc_solve
    from repro_torch.core.quantizers import QuantSpec

    card = dict(reversed(stage.lrc[:7]))  # layer 0's solves, by site name
    out = {}
    for shape, (name, w, st) in sorted(stage.sites.items()):
        t = time.perf_counter()
        w_paper = w.to(torch.float64).T.cpu()
        k = policy.rank(*shape)
        res = lrc_solve(w_paper, st.to("cpu"), QuantSpec(bits=policy.bits), k=k,
                        iters=policy.lrc_iters, quant_method=policy.quant_method)
        cpu_s = time.perf_counter() - t
        ref = card[name]
        codes = (torch.equal(res.qweight, ref.qweight.cpu())
                 and torch.equal(res.scales, ref.scales.cpu()))
        uv_c = res.u.double() @ res.v.double().T
        u, v = ref.u.cpu().double(), ref.v.cpu().double()
        uv_g = u @ v.T
        tol = CPU_REL * uv_g.abs().max() + 2 * 2.0 ** -24 * (u.abs() @ v.abs().T)
        uv_err = (uv_c - uv_g).abs()
        losses = [abs(a - b) / abs(b) for a, b in zip(res.losses + [res.oracle_loss],
                                                      ref.losses + [ref.oracle_loss])]
        ok = codes and bool((uv_err <= tol).all()) and max(losses) <= CPU_REL
        out[name] = {"shape": list(shape), "codes_bitwise": codes,
                     "uv_max_abs_diff": uv_err.max().item(),
                     "loss_max_rel_diff": max(losses), "cpu_s": cpu_s}
        print(f"  {name} {shape}: card vs CPU codes+scales "
              f"{'bitwise' if codes else 'DIFFER'}, U·Vᵀ max |diff| "
              f"{uv_err.max().item():.3e}, losses max rel {max(losses):.3e}; CPU "
              f"solve {cpu_s:.2f} s {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"calibration: {name} solved on the card disagrees with "
                             f"the CPU")
    return out


def phase_calibrate(device):
    """SmolLM-135M at full width and depth calibrated on the card (GPTQ +
    LRC + rotation over 32 x 2048 tokens, every layer's attention through
    the flash-attention kernel), its gates, then one full-width layer of
    Phi-3-mini over 16 x 2048 tokens.  Returns (cfg, params, launches,
    stats)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.loader import calib_sequences
    from repro_torch.models import model
    from repro_torch.quant.policy import QuantPolicy

    policy = QuantPolicy(**CALIB_POLICY)
    cfg = get_config("smollm-135m")
    params = model.init_params(cfg, seed=0, device=device)
    tokens = calib_sequences(cfg, n_seq=SMOL_CALIB_SEQS, seq_len=CALIB_SEQ_LEN,
                             device=device)
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, d_ff "
          f"{cfg.d_ff}, {cfg.dtype} weights from seed 0; {SMOL_CALIB_SEQS} x "
          f"{CALIB_SEQ_LEN} calibration tokens; {policy}", flush=True)
    stage = StageTimes()
    reset_launches()
    qparams = stage.run(cfg, params, tokens, policy)
    counts = launches()
    want = {k: (cfg.n_layers if k == "flash_attention" else 0) for k in counts}
    print(f"  launches {counts} (want {cfg.n_layers} flash_attention, 0 for the rest)",
          flush=True)
    if counts != want:
        raise SystemExit("calibration: the walk's attention did not go through the "
                         "flash-attention kernel once per layer")
    times = stage.summary()
    _print_times(cfg.name, times)
    if len(stage.lrc) != 7 * cfg.n_layers:
        raise SystemExit(f"calibration: {len(stage.lrc)} LRC solves, want "
                         f"{7 * cfg.n_layers}")
    _check_update_lr(stage)
    print(f"  Update-LR lowered or kept the loss at all {len(stage.lrc)} sites",
          flush=True)
    routes = _layer0_routes(cfg, stage, tokens, policy, device)
    cpu = _card_vs_cpu(stage, policy)
    del stage, params, tokens
    torch.cuda.empty_cache()

    pcfg = dataclasses.replace(get_config("phi3-mini-3.8b"), n_layers=1)
    pparams = model.init_params(pcfg, seed=0, device=device)
    ptokens = calib_sequences(pcfg, n_seq=PHI3_CALIB_SEQS, seq_len=CALIB_SEQ_LEN,
                              device=device)
    print(f"  {pcfg.name}: 1 layer, d_model {pcfg.d_model}, d_ff {pcfg.d_ff}; "
          f"{PHI3_CALIB_SEQS} x {CALIB_SEQ_LEN} tokens", flush=True)
    pstage = StageTimes()
    reset_launches()
    pstage.run(pcfg, pparams, ptokens, policy)
    if launches()["flash_attention"] != 1 or len(pstage.lrc) != 7:
        raise SystemExit("calibration: Phi-3's layer did not run its attention "
                         "through the kernel, or not every site was solved")
    _check_update_lr(pstage)
    ptimes = pstage.summary()
    _print_times(f"{pcfg.name} (1 layer)", ptimes)
    del pstage, pparams, ptokens
    torch.cuda.empty_cache()
    return cfg, qparams, counts, {"smollm": times, "phi3_one_layer": ptimes,
                                  "layer0_routes": routes, "card_vs_cpu": cpu}


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 1
    device = "cuda"
    # the plain versions' f32 products are the yardstick: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("1. card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"  {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    phase("2. build")
    seconds = build.build(build.KERNELS)
    for name, s in seconds.items():
        print(f"  {name}: {s:.1f} s", flush=True)
        print("\n".join("    " + line for line in build.BUILD_LOG.get(name, "").splitlines()
                        if "registers" in line or "spill" in line), flush=True)
    from repro_torch.kernels import fused_gemm

    for k, r in ((576, 58), (1536, 58), (3072, 307), (8192, 922)):
        want = fused_gemm._lib("fused_w4a4_lrc").fused_w4a4_lrc_smem_bytes(k, r)
        if fused_gemm.smem_bytes(k, r) != want:
            raise SystemExit(f"fused_gemm.smem_bytes({k}, {r}) is not the source's {want}")

    phase("3. kernels against their plain versions")
    worst, timed = phase_kernels(device)
    chain_worst, chain_timed = phase_chain_kernels(device)
    attn_worst, attn_timed = phase_attention_kernels(device)
    flash_worst, flash_timed = phase_flash_kernels(device)

    phase("4. serve SmolLM-135M (fused path)")
    cfg, qparams = build_model(device)
    smol_counts, serve = phase_serve(cfg, qparams, device, ["fused_w4a4_lrc"])

    phase("5. SmolLM-135M teacher-forced paged_step, kernel path against int8")
    parity = phase_parity(cfg, qparams, device)
    del qparams

    phase(f"6. serve Phi-3-mini, {PHI3_LAYERS} layers (chained path)")
    pcfg, pparams = build_model(device, "phi3-mini-3.8b", PHI3_LAYERS)
    phi3_counts, phi3_serve = phase_serve(pcfg, pparams, device,
                                          ["fused_prologue", "w4a4_lowrank_matmul"],
                                          route_ab=True)

    phase("7. Phi-3-mini teacher-forced paged_step, chained and unfused paths")
    paths = phase_paths(pcfg, pparams, device)

    phase("8. serve Phi-3-mini with quantized KV pools (int8, int4 group 32)")
    kv_serve, quant_launches = {}, 0
    for pool in ATTN_POOLS["paged_flash_attention_quant"]:
        spec = _kv_spec(pool)
        counts, stats = phase_serve(pcfg, pparams, device,
                                    ["fused_prologue", "w4a4_lowrank_matmul"],
                                    kv_spec=spec)
        quant_launches += counts["paged_flash_attention_quant"]
        kv_serve[pool] = dict(stats, routes=phase_kv_routes(pcfg, pparams, device, spec))
    del pparams

    phase("9. LRC calibration on the card (SmolLM-135M; one Phi-3-mini layer)")
    ccfg, cparams, calib_counts, calib = phase_calibrate(device)
    print("  serving the calibrated SmolLM-135M (fused path, f32 KV):", flush=True)
    _, calib["serve"] = phase_serve(ccfg, cparams, device, ["fused_w4a4_lrc"])

    def entry(name, replaces, n, sites, timing, err, at):
        layer = [timing[(name, SLOTS, *sites[s])] for s in sites]
        return {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": n, "max_abs_err": err,
            "ms": sum(t[0] for t in layer), "plain_ms": sum(t[1] for t in layer),
            "bound_ms": sum(t[2] for t in layer),
            "bound_by": "bytes" if all(t[3] == "bytes" for t in layer) else "operations",
            "library_ms": None, "at": at, "checked": True,
        }

    at_smol = f"one SmolLM-135M decoder layer's 7 sites at M={SLOTS}, L2 flushed"
    at_phi3 = f"one Phi-3-mini decoder layer's 7 sites at M={SLOTS}, L2 flushed"
    kernels = [
        entry("fused_w4a4_lrc", "src/repro/kernels/fused_gemm.py:208",
              smol_counts["fused_w4a4_lrc"], SITES, timed, worst, at_smol),
        entry("fused_prologue", "src/repro/kernels/prologue.py:93",
              phi3_counts["fused_prologue"], PHI3_SITES, chain_timed,
              chain_worst["fused_prologue"], at_phi3),
        entry("w4a4_lowrank_matmul", "src/repro/kernels/w4a4.py:98",
              phi3_counts["w4a4_lowrank_matmul"],
              PHI3_SITES, chain_timed, chain_worst["w4a4_lowrank_matmul"], at_phi3),
        entry("act_quant", "src/repro/kernels/actquant.py:31",
              paths["act_quant_launches"], PHI3_SITES, chain_timed,
              chain_worst["act_quant"], at_phi3 + "; launches from phase 7's unfused run"),
    ]

    def attn_entry(name, replaces, n, pool, at):
        t_k, t_p, b, by, t_l = attn_timed[(name, "phi3-serve", pool)]
        lk, lp, lb, lby, ll = attn_timed[(name, "phi3-long", pool)]
        return {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": n, "max_abs_err": attn_worst[name],
            "ms": t_k, "plain_ms": t_p, "bound_ms": b, "bound_by": by,
            "library_ms": t_l, "at": at, "checked": True,
            "long": {"ms": lk, "plain_ms": lp, "bound_ms": lb, "bound_by": lby,
                     "library_ms": ll, "lengths": ATTN_SHAPES["phi3-long"][6]},
        }

    at_attn = (f"one Phi-3-mini layer's decode attention, B={SLOTS}, lengths "
               f"{ATTN_SHAPES['phi3-serve'][6]}, {{}} pool, L2 flushed; launches "
               f"from {{}}")
    kernels += [
        attn_entry("paged_flash_attention", "src/repro/kernels/flash_attn.py:199",
                   smol_counts["paged_flash_attention"]
                   + phi3_counts["paged_flash_attention"], "f32",
                   at_attn.format("f32", "phases 4 and 6 (f32 KV)")),
        attn_entry("paged_flash_attention_quant", "src/repro/kernels/flash_attn.py:311",
                   quant_launches, "int8",
                   at_attn.format("int8", "phase 8 (int8 and int4 KV)")),
    ]
    t_k, t_p, b_ms, by, t_l = flash_timed["smollm-calib"]
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attn.py:241",
        "launches": calib_counts["flash_attention"], "max_abs_err": flash_worst,
        "ms": t_k, "plain_ms": t_p, "bound_ms": b_ms, "bound_by": by,
        "library_ms": t_l, "checked": True,
        "at": (f"one SmolLM-135M calibration layer's causal attention, B="
               f"{SMOL_CALIB_SEQS} S={CALIB_SEQ_LEN} H 9 KH 3 D 64 f32, L2 flushed; "
               f"library: SDPA is_causal on an expanded-KV copy; launches from "
               f"phase 9's walk"),
        "shapes": {k: dict(zip(("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms"), v)) for k, v in flash_timed.items()},
    })
    print(json.dumps({"serve": serve, "parity": parity, "phi3_serve": phi3_serve,
                      "phi3_paths": paths, "phi3_kv_serve": kv_serve,
                      "calibration": calib}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
