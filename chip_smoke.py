#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel of the port from ``src/repro_torch/kernels/csrc``
     (``build.KERNELS``, nine: one ``nvcc`` per source, all at once), check
     the rotation's host constant against the plain version's, count the
     tensor-core instructions (``cuobjdump -sass``; none is a failure):
     HMMA in the two dense flash libraries, IMMA in the W4A4 GEMM's and in
     the fused kernel's (which must hold no DP4A), and hold
     ``w4a4.gemm_plan``, ``prologue.prologue_plan``, ``fused_gemm.fused_plan``
     and ``fused_gemm.smem_bytes`` equal to the sources' plans and footprint
     at the served, prefill, phase-12 and ragged shapes, the prologue's and
     the fused kernel's registers and spills printed for each entry;
  3. the premises of the dense flash kernels' accuracy standard probed on
     the card (the TF32 split bitwise its plain emulation, one m16n8k8 mma
     on chosen addends within the model of its accumulation, what the card
     does printed); then each kernel against its plain PyTorch version on the card, at the
     shapes the serving and calibration paths give it plus ragged ones,
     with times: the fused kernel at SmolLM-135M's sites (each output
     bitwise the chained path's, #3 then #2, on the same inputs; its rows
     at M 4, 16 and 100 bitwise a 2048-row call's, unrotated and rotated),
     the prologue,
     GEMM and quantizer kernels at Phi-3-mini's (the GEMM's rows at M 1, 4,
     16 and 100 bitwise the same rows of a 2048-row call, per-token and at
     g 128, R 307, across its two tile regimes; the prologue's xq, sx and
     xv rows the same way at K 3072 and 8192 with R 307, K 8192 with R 922,
     rotated too, across its V stream and register tiles), the two paged attention
     kernels at both models' decode shapes, one long ragged Phi-3 batch and
     Gemma-7b's head_dim 256 (f32 and bf16 pools, int8 and int4 pools),
     with an inactive row and garbage in the pages no row owns, each within
     ``flash_attn.paged_attention_bound``, and at D 100 (the element-wise
     reader, three splits); their split-KV body's rows bitwise the same
     alone (pages moved) and in the batch, and at MPB 4 and 256; the dense
     causal flash-attention kernel at SmolLM's calibration shape, Phi-3's
     heads (f32, bf16), a ragged S, S = 1 and phase 16's head_dim 32 (an
     8 x 64 evaluation batch, the 24 x 96 calibration walk), and the
     prefill kernels: the quantized flash
     kernel (#8, int8 and int4 group 32) at the kv_sweep shape, a whole
     Phi-3 prompt and a 256-row chunk of it at position 1792, each with an
     f32 and a bf16 q, and a ragged S with a bf16 q, each bitwise #7 on the
     dequantized codes, and #7 with a query offset (f32, bf16, and the
     served models' bf16 q over an f32 pool at the Phi-3 chunk, a SmolLM
     serving slot and the kv_sweep shape); a chunk's rows bitwise the
     whole prompt's rows; the online rotation: the transform kernel (#5)
     bitwise its plain version (f32, bf16; Phi-3's wd at decode, 256 and
     2048 rows, a ragged short row, D = 2 and 16384) beside a matmul by
     H_D, the fused kernel's rotate branch at SmolLM-width sites with K a
     power of two, and the prologue's at Phi-3's wd (R 922, with V and
     without; M 4, 100 and 2048), codes and scales bitwise;
  4. serve SmolLM-135M at full width (random weights from seed 0, W4A4+LRC
     by RTN+SVD, f32 KV pool) through ``ServeEngine.submit``/``run`` and
     count that every QLinear went through the fused kernel, every decode
     step's attention through the paged attention kernel and every prefill
     chunk's through the flash-attention kernel; no memset in its profiled
     decode window;
  5. the same model's teacher-forced ``paged_step``, kernel path against the
     plain ``int8`` QLinear impl, every QLinear call bitwise the chained
     path on its activations, and the step on the chained path giving
     logits bitwise the fused step's;
  6. serve Phi-3-mini at full width (PHI3_LAYERS layers) on the
     same traffic: every QLinear demotes to the chained path (prologue →
     GEMM kernel), shown by ``health()["decode_plan"]`` and the counts;
     its decode window profiled (no memset may appear in it) with the
     attention on the kernel route and on the reference's gather route, in
     turns;
  7. Phi-3-mini's teacher-forced ``paged_step`` on the chained path, each
     call held against the plain chained pair, then on the unfused path
     (quantizer kernel → x·V in torch → GEMM kernel), the two compared;
  8. serve Phi-3-mini (phase 6's weights) with an int8 and an int4 (group
     32) KV pool: every decode step's attention through the quantized
     paged attention kernel, every prefill chunk's through the quantized
     flash kernel; one decode step on the kernel route, each attention
     call held against its plain version, and its logits beside the gather
     route's;
  9. LRC calibration on the card: SmolLM-135M at full width and depth
     (random bf16 weights from seed 0, 32 x 2048 calibration tokens, the
     serving CLI's policy: rotation, GPTQ, LRC with one iteration), every
     layer's causal attention through the flash-attention kernel (30
     launches, no plain version); Update-LR must not raise the loss at any
     site; layer 0 walked again on both attention routes (pre_o within the
     kernel's bound τ; each site's loss change within a limit derived from
     how far its input moved, and each limit below the loss); one site of
     each weight shape
     solved again on the CPU in f64 (codes bitwise, U·Vᵀ and losses within
     CPU_REL); the calibrated model served as in phase 4; then one
     full-width layer of Phi-3-mini calibrated over 16 x 2048 tokens; time
     per stage, the first call of each stage apart, and peak device memory
     for both;
 10. long prompts (2048, 1500, 777 and 130 tokens) on Phi-3-mini (phase
     6's weights) with f32, int8 and int4 (group 32) pools, whole and in
     100-row chunks on the kernel route: the greedy streams bitwise equal
     across the chunk widths, every chunk's attention through #7 or #8;
     the gather route beside it (ms per prefill chunk, peak memory, the
     first sampled token's logits), one chunk of each route profiled;
 11. the kv_sweep pass (``repro_torch.bench.kv_sweep``) of SmolLM-135M at
     full width, 4 x 2048 eval tokens, f32, int8 and int4 pools, on both
     routes: layer 0's kernel call within the bound of its plain
     version, its output within the bound of the gather route's, PPL, ACC
     and the logits' correlation;
 12. the paper's layer-latency tables (``repro_torch.bench.latency_kernels``,
     Tables 6-8): the smoke rows, then the W4A4+LRC layer rotated and
     unrotated at the paper's Llama sizes, every rank of RANKS and M of MS,
     and at Phi-3-mini's mlp/wd site, beside a bf16 matmul, each output held
     against its plain version; every rotated unfused call launches the
     transform kernel once, and nothing else launches it; the reference's
     grouped smoke row (g = 128) and a chained g = 128 column; then the GEMM
     kernel alone at those sizes, M 256 and 2048, ranks 0 and 128, beside
     its int8, f32 and bytes bounds, ``torch._int_mm`` on the unpacked codes
     and a bf16 matmul (context only);
 13. grouped activation scales (paper Table 2): (a) the group branches of
     #1 (SmolLM's sites at g 64, a rotated K 512 at g 128, groups that end
     inside a four-code word) and #2-#4 (Phi-3's sites and its rotated wd
     at g 128, K 192 in three groups, g = K, groups of 8, 10 and 45)
     against their plain versions at M 4, 100
     and 2048, bf16 and f32: codes and scale planes bitwise, the GEMMs
     without the LR term bitwise the canonical ``rowops.gemm_grouped``
     order, every row bitwise the same row of the M 2048 call (K split at
     decode or not), g = K bitwise the per-token kernel, #1 with V and
     without bitwise the chained path (#3 then #2); each beside its
     per-token time; (b) SmolLM-135M served at g 64 (fused: one #1 per
     QLinear call) and Phi-3-mini at g 128 (chained: one #3 and one #2),
     phases 4 and 6's weights retagged; (c) Phi-3's teacher-forced step on
     the chained and unfused paths at g 128, each call held against its
     plain pair, and two of phase 10's prompts whose greedy streams must be
     bitwise equal across prefill chunk widths None and 100; (d) one
     Phi-3-mini layer calibrated with act_group 128 (Update-LR never raises
     a loss);
 14. Gemma-7b, head_dim 256: (a) the dense flash kernels at D 64/96/128
     (ragged S, GQA, MQA, a query offset, D != Dv, int8 and int4 codes,
     head dims that are not multiples of 8) and at phase 3's prefill
     shapes, each within ``_flash_tolerance`` of its plain version and #8
     bitwise #7 on the dequantized codes; then #7 and #8 at Gemma's heads
     (B 1, S 2048, H 16, D 256; f32 and bf16 q), a 100-row chunk at 1900,
     the served shapes (a bf16 q over an f32 pool: 12 and 16 rows over one
     slot's 64 gathered rows, a 777-token prompt whole and its last 77-row
     chunk), MQA at D 256 and #7 at D 192 / Dv 128, each within the
     same bound of its plain version, #8 bitwise #7 on the dequantized codes
     and a chunk's rows bitwise the whole prompt's, with times beside the
     bound and SDPA; (b) Gemma-7b at full width (GEMMA_LAYERS layers, RTN +
     SVD on the card, the bf16 weights freed) served as in phase 6: every
     site on the chained path, prefill attention on #7 undemoted, exact
     launches; (c) prompts of 777 and 130 tokens whole and in 100-row chunks
     on f32 and int8 pools, the greedy streams bitwise equal across chunk
     widths; (d) the engine's deadlines on the card (a 1e-9 s deadline
     times out, a -1 s one is rejected, finished records carry timings);
 15. the serving contracts, run after phase 13 on phases 4 and 8's models
     and traffic (SLOTS slots, page PAGE, chunk CHUNK, N_REQUESTS x
     PROMPT_LEN-token prompts x NEW_TOKENS greedy tokens): (a) SmolLM-135M's
     chaos matrix (the reference's seven (kind, phase) rows, K = 2 of the 8
     requests targeted past the retry budget): the 6 untargeted streams
     bitwise phase 4's, the targets FAILED (a decode ``cache_corruption``
     victim as ``non_finite_logits``: its NaN reaches its logits on the
     kernel path and no other row) after ``max_retries``, the allocator
     whole, every page free, no NaN left in the pool, launches exact over
     every attempt; a sampled injector; transient decode ``exception`` and
     ``cache_corruption`` and a transient prefill ``cache_corruption`` (chunk
     4) finishing bitwise phase 4's streams (the in-place page rollback);
     (b) crashes (``process_crash``) mid-decode with a snapshot every step,
     mid-prefill (chunk 4), mid-decode with no snapshot (journal only, its
     slots' journaled tokens replayed) and with a snapshot every 4 steps and
     a crash in step 6 (the journal a step ahead of the snapshot: no slot
     resumes in place), each restored by ``ServeEngine.restore`` on the
     card: every rid terminal once in the journal, the journal's tokens the
     records', the streams bitwise phase 4's, launches exact, a pool
     restored from a snapshot bitwise the one it saved; (c) Phi-3-mini with
     an int8 pool: a crash mid-decode restored from a snapshot (codes and
     scale planes bitwise) and a transient decode ``cache_corruption``, both
     bitwise phase 8's int8 streams; (d) ``repro_torch.launch.serve``'s two
     harnesses in process (SmolLM ``--reduced`` and ``--full``,
     ``--quantize``), each returning 0; (e) one snapshot's bytes and
     seconds, the restores' seconds, phase 4's traffic with the journal on
     (fsync) and off, in tok/s, and the host seconds of the journal's
     appends (write and fsync) a record and a token, each beside the card's
     name and power limit;
 16. training and the paper's Table 1: (a) one train step of the
     reduced f32 model on the card against the same step on the CPU (TF32
     off; loss, every gradient leaf and the grad norm within the stated
     bounds); (b) ``train/trainer.train`` of SmolLM-135M at full width and
     depth (bf16 params, f32 moments), batch 16 x 128, lr 3e-4, 30 steps:
     every loss finite, the last 5 below the first 5, no kernel launched;
     step ms, tokens/s and peak memory printed; (c) 6 steps straight
     against 3, a restart from the checkpoint and 3 more: params and
     moments bitwise; (d) the benchmark model (``BENCH_CFG``) trained 300
     steps on the card, then Table 1 (FP16, QuaRot, SVD, LRC (1), LRC (5))
     with its calibration walks on #7 and every model on the sim column
     and the kernel column (#1 at every site, #7 in every forward): the
     launches exact, no NaN, every #1 call within ``lr_tolerance`` of its
     plain version and bitwise the chained path, the kernel column within
     ``bench.common.KERNEL_COLUMN_BOUND`` of sim and LRC (1)'s kernel
     column with half of its LR ranks or none (controls) outside it, the
     closed-gap fraction and each stage's seconds printed; (e) a grad-mode
     call into #1 and
     into #7 with an input that requires grad raises;
 17. (last) the moe family: DeepSeek-V2 at full width (DEEPSEEK_LAYERS = 2:
     layer 0 dense, layer 1 MoE with 160 routed experts top-6 and 2 shared;
     MLA with 128 heads, q_lora 1536, kv_lora 512), random bf16 weights
     from seed 0, every site W4A4+LRC by RTN + SVD on the card (seconds and
     peak memory printed), the bf16 weights freed: (a) served in the
     engine's per-slot mode (``health()["mode"] == "slots"``) on phase 4's
     traffic (SLOTS slots, max_seq 64): each QLinear call launches its
     path's kernels once (wkv_b fused, the rest chained, a routed expert
     stack once per expert), #7 once per layer per call, nothing else;
     each site's route, the median ms of a slot decode call and of a
     prompt's prefill, and a profiled window of slot decode calls; (b) one
     prefill and one decode call with every kernel call held to its plain
     version (#3's codes bitwise and x·V within ``xv_tolerance``, #2 within
     ``gemm_tolerance``, #1 within ``lr_tolerance`` and bitwise the chained
     path, wkv_b's all-zero cache rows bitwise, #7 within
     ``_flash_tolerance``; all 160 experts' sites, some picked by no
     token); (c) #7 at the served shapes (Sq 12 at q_start 0, Sq 1 at
     q_start 12-27, Skv 64, H = KH = 128, D 192, Dv 128, bf16) within
     ``_flash_tolerance``, timed beside SDPA, and every distinct W4A4 site
     timed on its served inputs; (d) the router's top-6 indices on the card
     equal the CPU's on the same bf16 rows (also with tied expert pairs,
     lower index first); (e) each request served alone bitwise its
     co-tenant stream, and a crash mid-decode restored from a snapshot
     (some slots resumed in place, some replayed from the journal) bitwise
     the uninterrupted run; (f) ``_quantize_moe`` (GPTQ + LRC, per-expert
     statistics) of the reduced DeepSeek-V2 on the card, one site of each
     shape solved again on the CPU (codes bitwise), the logits of the two
     walks correlated at least 0.9; (g) ``mla_absorb`` on the served model:
     one prefill and DS_ABSORB_DECODES decode calls teacher-forced against
     the naive path, every MLA attention call held to the naive path's on
     the same inputs and wkv_b's effective weight (correlation at least
     ABSORB_MIN_CORRELATION, within ABSORB_MAX_REL of the largest output;
     the model's logits against the served naive path's printed), wall and
     device-busy ms per decode call beside the naive path's;
 18. (a) Phi-4-mini at full width (``PHI4_LAYERS`` of 32 layers: 24/8 heads
     of 128, d_ff 8,192, vocab 200,064), random bf16 weights from seed 0,
     RTN+SVD on the card (seconds and peak GB printed), served on the
     chained path on phase 4's traffic with exact launches, then SLOTS
     prefill chunks and one decode step with every kernel call (#3, #2, #6,
     #7) held to its plain version; (b) the same model through the
     contiguous cache (``model.init_cache`` f32 B 1 max_seq 64,
     ``prefill``, ``decode_step``; #7 at ``q_start``), teacher-forced with
     the paged engine's stream: launches exact, every kernel call of both
     paths' NEW_TOKENS calls held to its plain version, the prefill's
     logits bitwise the engine's (#7 on the same operands), every step's
     correlation at least CONTIG_MIN_CORRELATION; the witnesses: both
     paths' attention calls walked in order (every q bitwise equal up to
     the first attention output that differs), the gather route in both
     bitwise at every step, f32 weights within CONTIG_F32_REL at every
     step; the greedy agreement printed, and a decode call timed at max_seq
     64 and CONTIG_LONG_SEQ; (c) ``launch.quantize`` (GPTQ + LRC) on SmolLM-135M
     at full width from a checkpoint the phase writes: the walk's launches
     exact, the output loaded through ``shell.quantized_param_shapes``
     bitwise, then both trees served after ``retag_qlinear_impl`` with
     every QLinear through #1, the loaded model's streams bitwise the
     in-memory model's; (d) the reduced DeepSeek-V3 (CE + MTP) and -V2: a
     train step on the card against the CPU's (phase 16's standard), then
     MOE_TRAIN_STEPS steps with the loss finite and falling and no kernel
     launched;
then a ``{"kernels": [...]}`` line and, last, the device line.
Without a card, or without the repository beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): device memory, dense int8 and TF32
# tensor cores, non-tensor f32
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
TF32_OPS_PER_S = 495e12
F32_OPS_PER_S = 67e12

# Phi-3-mini's depth served here: 16 of its 32 layers.  The RTN+SVD
# quantization (a float64 SVD of up to 8192 x 3072 per site, ~1 s each on
# the card, 6.6 s a layer) dominates the script's time; all 32 layers
# (210 s of RTN+SVD) and phase 17 together would take the script past
# 1,000 s of its 1,200 s limit, so half are served
PHI3_LAYERS = 16
# Gemma-7b's depth served in phase 14: 4 of its 28 layers.  Its RTN+SVD
# quantization (a float64 SVD of up to 24576 x 3072 per site, ~6.6 s a
# layer) was the longest step of the script at 14 layers (93 s); phase
# 17's DeepSeek-V2 (~130 s of RTN+SVD) took that room.  Cut this first,
# then PHI3_LAYERS, if the script must shrink (width is never cut)
GEMMA_LAYERS = 4

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
    from repro_torch.kernels import (actquant, flash_attn, fused_gemm, hadamard,
                                     prologue, w4a4)

    return (fused_gemm, prologue, w4a4, actquant, flash_attn, hadamard)


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


def _bound(nbytes, int8_ops=0, f32_ops=0, tf32_ops=0):
    """Least time on an H100 SXM (ms) and what bounds it: the bytes over
    3.35 TB/s, or the int8, f32 and TF32 operations over their peak
    rates."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (int8_ops / INT8_OPS_PER_S + f32_ops / F32_OPS_PER_S
             + tf32_ops / TF32_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _bound_ms(m, k, n, r, x_bytes, f_bytes):
    """The fused kernel's bound: each input read once, the f32 output
    written once; the int8 GEMM plus the f32 LR products."""
    return _bound(k * n // 2 + 4 * n + f_bytes * r * (k + n) + x_bytes * m * k
                  + 4 * m * n, int8_ops=2 * m * k * n, f32_ops=2 * m * r * (k + n))


def _fused_chained(x, v, wp, sw, u, rot=False, g=None, bits=4, clip=0.9):
    """The chained path on the fused kernel's inputs: the prologue kernel
    (#3), then the GEMM kernel (#2)."""
    from repro_torch.kernels import prologue, w4a4

    xq, sx, xv = prologue.fused_prologue(x, v, bits, clip, rot, g)
    return w4a4.w4a4_lowrank_matmul(xq, sx, wp, sw, xv, u, g)


def _fused_gate(y, x, v, wp, sw, u, rot, g, what):
    """#1's output bitwise the chained path's on the same inputs."""
    import torch

    y_ch = _fused_chained(x, v, wp, sw, u, rot, g)
    torch.cuda.synchronize()
    if not torch.equal(y, y_ch):
        d = (y - y_ch).abs()
        raise SystemExit(f"fused kernel not bitwise the chained path at {what}: max |diff| "
                         f"{d.max().item():.3e}, {int((d > 0).sum())} outputs differ")


def _fused_rows_gate(x_all, v, wp, sw, u, rot, g, ms, what):
    """#1's rows of M in ``ms`` bitwise the same rows of the call on all of
    ``x_all``, and each call bitwise the chained path's."""
    import torch

    from repro_torch.kernels import fused_gemm

    whole = fused_gemm.fused_w4a4_lrc(x_all, v, wp, sw, u, 4, 0.9, rot, g)
    _fused_gate(whole, x_all, v, wp, sw, u, rot, g, f"{what} M={x_all.shape[0]}")
    for m in ms:
        y = fused_gemm.fused_w4a4_lrc(x_all[:m], v, wp, sw, u, 4, 0.9, rot, g)
        torch.cuda.synchronize()
        if not torch.equal(y, whole[:m]):
            raise SystemExit(f"fused kernel: rows of M={m} are not those of M="
                             f"{x_all.shape[0]} at {what}")
        _fused_gate(y, x_all[:m], v, wp, sw, u, rot, g, f"{what} M={m}")


# M of the fused kernel's rows gates, and of the call they are held to
FUSED_ROW_MS, FUSED_ROW_WHOLE = (SLOTS, CHUNK, 100), 2048

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

    from repro_torch.bench.common import flush_buffer, lr_tolerance, time_ms, w4a4_problem
    from repro_torch.kernels import fused_gemm

    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=device).manual_seed(0)
    shapes = sorted(set(SITES.values()))
    cases = [(m, k, n, r, bf16, bf16) for (k, n, r) in shapes
             for m in (SLOTS, CHUNK)]
    cases += [(17, 200, 97, 7, bf16, bf16), (3, 90, 33, 0, bf16, bf16),
              (1, 576, 577, 58, bf16, bf16), (33, 1536, 1, 5, bf16, bf16),
              (5, 256, 130, 40, f32, f32), (16, 576, 64, 58, f32, bf16)]
    flush = flush_buffer(device)
    one = torch.zeros(1, device=device)
    floor = time_ms(lambda: one.add_(1), flush)
    print(f"  timing floor (one 1-element add, same method): {floor * 1e3:.2f} us",
          flush=True)
    worst = 0.0
    timed = {}
    for (m, k, n, r, xd, fd) in cases:
        x, v, wp, sw, u = w4a4_problem(gen, m, k, n, r, xd, fd, device)
        y = fused_gemm.fused_w4a4_lrc(x, v, wp, sw, u, 4, 0.9)
        torch.cuda.synchronize()
        _fused_gate(y, x, v, wp, sw, u, False, None, f"M={m} K={k} N={n} R={r}")
        y_plain = fused_gemm.fused_w4a4_lrc_plain(x, v, wp, sw, u, 4, 0.9)
        tol = lr_tolerance(x, v, u, k, r, y_plain)
        err = (y - y_plain).abs()
        ok = bool(torch.isfinite(y).all()) and bool((err <= tol).all())
        print(f"  M={m:<3} K={k:<5} N={n:<5} R={r:<3} x={str(xd)[6:]:<8} "
              f"max_abs_err={err.max().item():.3e} "
              f"limit={tol.max().item():.3e} {'ok' if ok else 'FAIL'}; bitwise the chained "
              f"path", flush=True)
        if not ok:
            raise SystemExit(f"kernel disagrees with its plain version at "
                             f"M={m} K={k} N={n} R={r}")
        worst = max(worst, err.max().item())
        if xd is bf16 and fd is bf16 and (k, n, r) in shapes:
            t_k = time_ms(lambda: fused_gemm.fused_w4a4_lrc(x, v, wp, sw, u, 4, 0.9), flush)
            t_p = time_ms(lambda: fused_gemm.fused_w4a4_lrc_plain(x, v, wp, sw, u, 4, 0.9), flush)
            b, by = _bound_ms(m, k, n, r, 2, 2)
            timed[("fused_w4a4_lrc", m, k, n, r)] = (t_k, t_p, b, by)
            print(f"    kernel {t_k * 1e3:.2f} us  plain {t_p * 1e3:.2f} us  "
                  f"bound {b * 1e3:.3f} us ({by})  library_ms null "
                  f"(no single PyTorch call computes this function)",
                  flush=True)
    for (k, n, r) in shapes:
        x_all, v, wp, sw, u = w4a4_problem(gen, FUSED_ROW_WHOLE, k, n, r, bf16, bf16, device)
        _fused_rows_gate(x_all, v, wp, sw, u, False, None, FUSED_ROW_MS, f"K={k} N={n} R={r}")
    print(f"  rows of M {FUSED_ROW_MS} bitwise the M={FUSED_ROW_WHOLE} call's at the "
          f"{len(shapes)} site shapes, each call bitwise the chained path's", flush=True)
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


def phase_chain_kernels(device):
    """The prologue, GEMM and quantizer kernels at Phi-3-mini's three site
    shapes (M = decode slots and prefill chunk), the paper's 30 % rank
    (R = 922) and ragged cases (odd N, K % 4 == 2, K % 16 != 0, K = 16384,
    R = 0 and 1024, M over one tile, f32 operands).  Codes and scales must
    be bitwise the plain version's (and the two quantizers' the same);
    x·V and the GEMM output within their summation bounds."""
    import torch

    from repro_torch.bench.common import (flush_buffer, gemm_tolerance, time_ms,
                                          w4a4_problem, xv_tolerance)
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
    flush = flush_buffer(device)
    worst = {"fused_prologue": 0.0, "w4a4_lowrank_matmul": 0.0, "act_quant": 0.0}
    timed = {}
    for (m, k, n, r, xd, fd) in cases:
        x, v, wp, sw, u = w4a4_problem(gen, m, k, n, r, xd, fd, device)
        xq, sx, xv = prologue.fused_prologue(x, v, 4, 0.9)
        aq, asx = actquant.act_quant(x, 4, 0.9)
        torch.cuda.synchronize()
        xq_p, sx_p, xv_p = prologue.fused_prologue_plain(x, v, 4, 0.9)
        codes = (torch.equal(xq, xq_p) and torch.equal(sx, sx_p)
                 and torch.equal(aq, xq_p) and torch.equal(asx, sx_p))
        xv_err = xv_ok = 0.0
        if r:
            err = (xv - xv_p).abs()
            xv_ok = bool((err <= xv_tolerance(x, v, k, xv_p)).all())
            xv_err = err.max().item()
        # the GEMM on the plain prologue's outputs, so both see one input
        y = w4a4.w4a4_lowrank_matmul(xq_p, sx_p, wp, sw, xv_p, u)
        torch.cuda.synchronize()
        y_p = w4a4.w4a4_lowrank_matmul_plain(xq_p, sx_p, wp, sw, xv_p, u)
        err = (y - y_p).abs()
        y_ok = (bool(torch.isfinite(y).all())
                and bool((err <= gemm_tolerance(xv_p, u, r, y_p)).all()))
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
                t_k, t_p = time_ms(kern, flush), time_ms(plain, flush)
                b, by = bounds[name]
                timed[(name, m, k, n, r)] = (t_k, t_p, b, by)
                print(f"    {name:<20} kernel {t_k * 1e3:8.2f} us  plain "
                      f"{t_p * 1e3:9.2f} us  bound {b * 1e3:.3f} us ({by})  "
                      f"library_ms null", flush=True)
    print("  library_ms is null for all three: no single PyTorch call computes "
          "the int4 GEMM with its rescale and LR epilogue, the quantizer, or "
          "the quantizer with x·V", flush=True)
    _gemm_rows_gate(device)
    _prologue_rows_gate(device)
    _quant_rows_gate(device)
    timed.update(_quant_times(device))
    return worst, timed


# the quantizer's rows gate and times: Phi-3-mini's two site K and phase
# 12's K; M of its times
QUANT_KS = (3072, 4096, 5120, 8192)
QUANT_MS = (SLOTS, CHUNK, 256, 2048)


def _quant_rows_gate(device):
    """The quantizer kernel's rows do not depend on M, fatal: at QUANT_KS,
    per token and at g 128 (bf16 x as served), each row of the codes and
    scales of calls at M = GEMM_ROW_MS is bitwise the same row of the
    2048-row call on the same rows, and the 2048-row call bitwise the plain
    version.  Its plan is the same at every M (``act_quant_plan``).  Rows
    too wide for a block's registers (the staged body) are held bitwise the
    plain version too."""
    import torch

    from repro_torch.kernels import actquant

    gen = torch.Generator(device=device).manual_seed(5)
    mmax = 2048
    for k in QUANT_KS:
        x = torch.randn((mmax, k), generator=gen, device=device).to(torch.bfloat16)
        for g in (None, PHI3_GROUP):
            whole = actquant.act_quant(x, 4, 0.9, g)
            torch.cuda.synchronize()
            for a, b, what in zip(whole, actquant.act_quant_plain(x, 4, 0.9, g), ("xq", "sx")):
                if not torch.equal(a, b):
                    raise SystemExit(f"act_quant {what} at M={mmax} K={k} g={g} is not bitwise "
                                     f"its plain version")
            for m in GEMM_ROW_MS:
                part = actquant.act_quant(x[:m].contiguous(), 4, 0.9, g)
                torch.cuda.synchronize()
                for a, b, what in zip(part, whole, ("xq", "sx")):
                    if not torch.equal(a, b[:m]):
                        raise SystemExit(f"act_quant {what} rows at M={m} K={k} g={g} are not "
                                         f"bitwise the same rows of the M={mmax} call")
            p = actquant.act_quant_plan(mmax, k, g, 2)
            print(f"  act_quant rows K={k:<5} g={g}: M {GEMM_ROW_MS} bitwise the M={mmax} "
                  f"call's rows (plan: {p.tpr} threads a row, {p.loads} 16-byte loads a "
                  f"thread, {p.rows_per_block} rows a block)", flush=True)
        del x
    # rows too wide for a block's registers take the staged body
    for k, dt in ((40000, torch.bfloat16), (20000, torch.float32)):
        x = torch.randn((3, k), generator=gen, device=device).to(dt)
        if not actquant.act_quant_plan(3, k, None, x.element_size()).staged:
            raise SystemExit(f"act_quant's plan does not stage a row of {k} {dt}")
        got = actquant.act_quant(x, 4, 0.9)
        torch.cuda.synchronize()
        for a, b, what in zip(got, actquant.act_quant_plain(x, 4, 0.9), ("xq", "sx")):
            if not torch.equal(a, b):
                raise SystemExit(f"act_quant {what} of a staged row K={k} {dt} is not bitwise "
                                 f"its plain version")
    print("  act_quant staged rows (K 40000 bf16, 20000 f32) bitwise the plain version",
          flush=True)


def _quant_times(device):
    """The quantizer kernel alone at M = QUANT_MS over QUANT_KS, per token
    and at g 128 (bf16 x), beside its bound (``_chain_bounds``'s, the scale
    plane in place of the scales at g 128) and its plain version: µs, median
    of 30 calls, L2 flushed."""
    import torch

    from repro_torch.bench.common import flush_buffer, time_ms
    from repro_torch.kernels import actquant

    gen = torch.Generator(device=device).manual_seed(6)
    flush = flush_buffer(device)
    timed = {}
    print("  act_quant alone (bf16 x; µs, median of 30, L2 flushed; bound: x read, codes "
          "and scales written once):", flush=True)
    for g in (None, PHI3_GROUP):
        for m in QUANT_MS:
            for k in QUANT_KS:
                x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
                t_k = time_ms(lambda: actquant.act_quant(x, 4, 0.9, g), flush)
                t_p = time_ms(lambda: actquant.act_quant_plain(x, 4, 0.9, g), flush)
                b, by = _bound(3 * m * k + 4 * m * (k // g if g else 1), f32_ops=3 * m * k)
                timed[("act_quant_alone", m, k, g)] = (t_k, t_p, b, by)
                print(f"    g={str(g):<4} M={m:<5} K={k:<5} kernel {t_k * 1e3:8.2f}  plain "
                      f"{t_p * 1e3:9.2f}  bound {b * 1e3:7.3f} ({by}; {t_k / b:.1f}x)",
                      flush=True)
    return timed


# M of the calls whose rows must be bitwise the 2048-row call's
GEMM_ROW_MS = (1, SLOTS, CHUNK, 100)
# the prologue's rows gate (K, R, rotate): Phi-3-mini's two site K at R 307,
# its wd at the paper's 30 % rank, and that one rotated
PROLOGUE_ROW_CASES = [(3072, 307, False), (8192, 307, False), (8192, 922, False),
                      (8192, 922, True)]


def _prologue_rows_gate(device):
    """The prologue kernel's rows do not depend on M, fatal: for each of
    PROLOGUE_ROW_CASES, per-token and at g 128 (bf16 x and V as served),
    each row of xq, sx and xv of calls at M = GEMM_ROW_MS is bitwise the
    same row of the 2048-row call on the same rows.  The calls span both
    regimes (M <= 16 streams V, with 4- and 8-row tiles; M 100 streams at
    R 307 and takes the register tiles at R 922; M 2048 the register tiles)."""
    import torch

    from repro_torch.bench.common import w4a4_problem
    from repro_torch.kernels import prologue

    bf16 = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(3)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mmax = 2048
    for (k, r, rot) in PROLOGUE_ROW_CASES:
        for g in (None, PHI3_GROUP):
            x, v, _, _, _ = w4a4_problem(gen, mmax, k, 1, r, bf16, bf16, device, g)
            whole = prologue.fused_prologue(x, v, 4, 0.9, rot, g)
            plans = []
            for m in GEMM_ROW_MS:
                part = prologue.fused_prologue(x[:m].contiguous(), v, 4, 0.9, rot, g)
                torch.cuda.synchronize()
                for a, b, what in zip(part, whole, ("xq", "sx", "xv")):
                    if not torch.equal(a, b[:m]):
                        raise SystemExit(f"prologue {what} rows at M={m} K={k} R={r} g={g} "
                                         f"rotate={rot} are not bitwise the same rows of the "
                                         f"M={mmax} call")
                p = prologue.prologue_plan(m, k, r, rot, 2, 2, sms)
                plans.append(f"M {m}: {'tiled' if p.tiled else f'stream {p.rows}-row'}")
            p = prologue.prologue_plan(mmax, k, r, rot, 2, 2, sms)
            print(f"  prologue rows K={k:<5} R={r:<4} g={g} rotate={rot!s:<5}: M {GEMM_ROW_MS} "
                  f"bitwise the M={mmax} call's rows ({'; '.join(plans)}; M {mmax}: "
                  f"{'tiled' if p.tiled else 'stream'}, {p.splits} split"
                  f"{'s' if p.splits > 1 else ''})", flush=True)
            del x, v, whole


def _gemm_rows_gate(device):
    """The GEMM kernel's rows do not depend on M, fatal: at Phi-3-mini's
    three site shapes, R 307 (bf16 U), per-token and at g 128, each row of
    calls at M = GEMM_ROW_MS is bitwise the same row of the 2048-row call on
    the same operands (the first rows of its codes, scales and x·V).  The
    calls span both tile regimes (M <= 16 streams W with K split across
    blocks and the LR term in blocks of its own; larger M takes 128 x 128
    tiles over all of K)."""
    import torch

    from repro_torch.bench.common import w4a4_problem
    from repro_torch.kernels import prologue, w4a4

    bf16 = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mmax = 2048
    for (k, n, r) in sorted(set(PHI3_SITES.values())):
        for g in (None, PHI3_GROUP):
            x, v, wp, sw, u = w4a4_problem(gen, mmax, k, n, r, bf16, bf16, device, g)
            xq, sx, xv = prologue.fused_prologue_plain(x, v, 4, 0.9, False, g)
            whole = w4a4.w4a4_lowrank_matmul(xq, sx, wp, sw, xv, u, g)
            plans = []
            for m in GEMM_ROW_MS:
                y = w4a4.w4a4_lowrank_matmul(xq[:m].contiguous(), sx[:m].contiguous(), wp,
                                             sw, xv[:m].contiguous(), u, g)
                torch.cuda.synchronize()
                if not torch.equal(y, whole[:m]):
                    raise SystemExit(f"GEMM rows at M={m} K={k} N={n} R={r} g={g} are not "
                                     f"bitwise the same rows of the M={mmax} call")
                p = w4a4.gemm_plan(m, k, n, g, sms)
                plans.append(f"M {m}: {'decode' if p.decode else 'large'}, "
                             f"{p.splits} split{'s' if p.splits > 1 else ''}")
            print(f"  GEMM rows K={k:<5} N={n:<5} R={r} g={g}: M {GEMM_ROW_MS} bitwise the "
                  f"M={mmax} call's rows ({'; '.join(plans)}; M {mmax}: large, 1 split)",
                  flush=True)
            del x, v, wp, sw, u, xq, sx, xv, whole


# kernel #5 (M, D): Phi-3-mini's mlp/wd at decode, phase 12's K at M 256 and
# 2048, a ragged short row, the narrowest row, a row wider than any site and
# the widest row the kernel takes
FWHT_SHAPES = [(4, 8192), (256, 4096), (2048, 8192), (13, 512), (1, 2), (8, 16384), (3, 32768)]
# #5's rows gate: D and the M of the call the rows are held to
FWHT_ROW_DS, FWHT_ROW_WHOLE = (4096, 8192), 2048
# the fused kernel's rotate branch at SmolLM-width sites (K, N, R), K a power
# of two; then a ragged one (odd N, M over one tile) and f32 operands
ROT_FUSED_SITES = [(256, 576, 58), (512, 1536, 58), (1024, 576, 58)]
# the prologue's rotate branch (M, K, R): Phi-3-mini's mlp/wd at the paper's
# 30 % rank at decode, a 100-row chunk and prefill M, then without V
ROT_PROLOGUE_CASES = [(SLOTS, 8192, 922), (100, 8192, 922), (2048, 8192, 922),
                      (SLOTS, 8192, 0), (100, 8192, 0)]


def _hadamard_matrix(d, device):
    """The normalized Walsh-Hadamard matrix H_D in f32 on the card: entry
    (i, j) is (-1)^popcount(i & j) / sqrt(D)."""
    import torch

    i = torch.arange(d, device=device, dtype=torch.int32)
    a = i[:, None] & i[None, :]
    parity = torch.zeros_like(a)
    for _ in range(max(1, d.bit_length() - 1)):
        parity ^= a & 1
        a >>= 1
    del a
    return (1 - 2 * parity).to(torch.float32) * (1.0 / d**0.5)


def _log2(d):
    return d.bit_length() - 1


def phase_rotate_kernels(device):
    """The online rotation's kernels against their plain versions.

    (a) kernel #5 (``csrc/fwht.cu``) at FWHT_SHAPES, f32 and bf16: bitwise
        ``fwht_plain``; times beside its bytes bound and one
        ``torch.matmul(x.float(), H_D)`` (TF32 off).
    (b) the fused kernel's rotate branch at ROT_FUSED_SITES (M = decode
        slots and prefill chunk, bf16 as served) and ragged cases: within
        the LR-sum bound of its plain version on the rotated rows; timed
        beside the unrotated branch at M = SLOTS.
    (c) the prologue's rotate branch at ROT_PROLOGUE_CASES (bf16): codes and
        scales bitwise its plain version, x·V within its bound on the
        rotated rows; with an f32 x, its codes and scales bitwise those of
        #5 then the quantizer kernel (the unfused path's); timed beside the
        unrotated branch."""
    import torch

    from repro_torch.bench.common import (flush_buffer, lr_tolerance, time_ms,
                                          w4a4_problem, xv_tolerance)
    from repro_torch.kernels import actquant, fused_gemm, hadamard, prologue

    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=device).manual_seed(2)
    flush = flush_buffer(device)
    worst = {"fwht": 0.0, "fused_w4a4_lrc": 0.0, "fused_prologue": 0.0}
    timed = {}

    print("  (a) fwht (#5) against fwht_plain, bitwise", flush=True)
    for m, d in FWHT_SHAPES:
        h = _hadamard_matrix(d, device)
        for dt in (f32, bf16):
            x = torch.randn((m, d), generator=gen, device=device).to(dt)
            y = hadamard.fwht(x)
            torch.cuda.synchronize()
            y_p = hadamard.fwht_plain(x)
            err = (y.float() - y_p.float()).abs().max().item()
            ok = torch.equal(y, y_p) and y.dtype == dt
            t_k = time_ms(lambda: hadamard.fwht(x), flush)
            t_p = time_ms(lambda: hadamard.fwht_plain(x), flush)
            t_l = time_ms(lambda: torch.matmul(x.float(), h), flush)
            b, by = _bound(2 * m * d * x.element_size(), f32_ops=m * d * _log2(d))
            timed[("fwht", m, d, str(dt)[6:])] = (t_k, t_p, b, by, t_l)
            print(f"    M={m:<5} D={d:<6} {str(dt)[6:]:<9} "
                  f"{'bitwise' if ok else 'DIFFER'}  kernel {t_k * 1e3:9.2f} us  plain "
                  f"{t_p * 1e3:9.2f} us  bound {b * 1e3:8.3f} us ({by})  "
                  f"library (matmul by H_D, f32) {t_l * 1e3:9.2f} us", flush=True)
            if not ok:
                raise SystemExit(f"fwht disagrees with its plain version at M={m} "
                                 f"D={d} {dt} (max |diff| {err:.3e})")
        del h
    for d in FWHT_ROW_DS:
        for dt in (f32, bf16):
            x = torch.randn((FWHT_ROW_WHOLE, d), generator=gen, device=device).to(dt)
            whole = hadamard.fwht(x)
            torch.cuda.synchronize()
            if not torch.equal(whole, hadamard.fwht_plain(x)):
                raise SystemExit(f"fwht at M={FWHT_ROW_WHOLE} D={d} {dt} is not bitwise its "
                                 f"plain version")
            for m in GEMM_ROW_MS:
                part = hadamard.fwht(x[:m].contiguous())
                torch.cuda.synchronize()
                if not torch.equal(part, whole[:m]):
                    raise SystemExit(f"fwht rows at M={m} D={d} {dt} are not bitwise the same "
                                     f"rows of the M={FWHT_ROW_WHOLE} call")
    print(f"    rows of M {GEMM_ROW_MS} bitwise the M={FWHT_ROW_WHOLE} call's at D "
          f"{FWHT_ROW_DS}, f32 and bf16", flush=True)

    print("  (b) fused_w4a4_lrc rotate branch against its plain version", flush=True)
    cases = [(mm, k, n, r, bf16, bf16) for (k, n, r) in ROT_FUSED_SITES for mm in (SLOTS, CHUNK)]
    cases += [(17, 512, 97, 7, bf16, bf16), (5, 256, 130, 40, f32, f32), (3, 64, 33, 0, bf16, bf16)]
    for (m, k, n, r, xd, fd) in cases:
        x, v, wp, sw, u = w4a4_problem(gen, m, k, n, r, xd, fd, device)
        y = fused_gemm.fused_w4a4_lrc(x, v, wp, sw, u, 4, 0.9, rotate=True)
        torch.cuda.synchronize()
        _fused_gate(y, x, v, wp, sw, u, True, None, f"rotated M={m} K={k} N={n} R={r}")
        y_p = fused_gemm.fused_w4a4_lrc_plain(x, v, wp, sw, u, 4, 0.9, rotate=True)
        x_rot = hadamard.fwht_plain(x.float())
        err = (y - y_p).abs()
        ok = bool(torch.isfinite(y).all()) and bool((err <= lr_tolerance(x_rot, v, u, k, r, y_p)).all())
        print(f"    M={m:<3} K={k:<5} N={n:<5} R={r:<3} x={str(xd)[6:]:<8} "
              f"max_abs_err={err.max().item():.3e} {'ok' if ok else 'FAIL'}; bitwise the "
              f"chained path", flush=True)
        if not ok:
            raise SystemExit(f"fused rotate branch disagrees with its plain version "
                             f"at M={m} K={k} N={n} R={r}")
        worst["fused_w4a4_lrc"] = max(worst["fused_w4a4_lrc"], err.max().item())
        if m == SLOTS and (k, n, r) in ROT_FUSED_SITES:
            t_r = time_ms(lambda: fused_gemm.fused_w4a4_lrc(x, v, wp, sw, u, 4, 0.9,
                                                             rotate=True), flush)
            t_u = time_ms(lambda: fused_gemm.fused_w4a4_lrc(x, v, wp, sw, u, 4, 0.9), flush)
            t_p = time_ms(lambda: fused_gemm.fused_w4a4_lrc_plain(x, v, wp, sw, u, 4, 0.9,
                                                                   rotate=True), flush)
            # _bound_ms's bytes and operations, plus the rotation's adds
            b, by = _bound(k * n // 2 + 4 * n + 2 * r * (k + n) + 2 * m * k + 4 * m * n,
                           int8_ops=2 * m * k * n,
                           f32_ops=2 * m * r * (k + n) + m * k * _log2(k))
            timed[("fused_w4a4_lrc", m, k, n, r)] = (t_r, t_u, t_p, b, by)
            print(f"      rotated {t_r * 1e3:.2f} us  unrotated {t_u * 1e3:.2f} us  plain "
                  f"{t_p * 1e3:.2f} us  bound {b * 1e3:.3f} us ({by})", flush=True)

    for (k, n, r) in ROT_FUSED_SITES:
        x_all, v, wp, sw, u = w4a4_problem(gen, FUSED_ROW_WHOLE, k, n, r, bf16, bf16, device)
        _fused_rows_gate(x_all, v, wp, sw, u, True, None, FUSED_ROW_MS,
                         f"rotated K={k} N={n} R={r}")
    print(f"    rotated rows of M {FUSED_ROW_MS} bitwise the M={FUSED_ROW_WHOLE} call's, each "
          f"call bitwise the chained path's", flush=True)

    print("  (c) fused_prologue rotate branch against its plain version", flush=True)
    cases = [(m, k, r, bf16) for (m, k, r) in ROT_PROLOGUE_CASES] + [(2048, 8192, 922, f32),
                                                                    (7, 256, 33, f32)]
    for (m, k, r, xd) in cases:
        x, v, _, _, _ = w4a4_problem(gen, m, k, 1, r, xd, bf16, device)
        xq, sx, xv = prologue.fused_prologue(x, v, 4, 0.9, rotate=True)
        torch.cuda.synchronize()
        xq_p, sx_p, xv_p = prologue.fused_prologue_plain(x, v, 4, 0.9, rotate=True)
        codes = torch.equal(xq, xq_p) and torch.equal(sx, sx_p)
        if xd is f32:  # the unfused path's codes: #5, then the quantizer kernel
            aq, asx = actquant.act_quant(hadamard.fwht(x), 4, 0.9)
            codes = codes and torch.equal(aq, xq) and torch.equal(asx, sx)
        xv_err, xv_ok = 0.0, True
        if r:
            x_rot = hadamard.fwht_plain(x.float())
            err = (xv - xv_p).abs()
            xv_ok = bool((err <= xv_tolerance(x_rot, v, k, xv_p)).all())
            xv_err = err.max().item()
        print(f"    M={m:<5} K={k:<5} R={r:<4} x={str(xd)[6:]:<8} codes+scales "
              f"{'bitwise' if codes else 'DIFFER'}"
              f"{' (also #5 then act_quant)' if xd is f32 else ''}  xv max_abs_err="
              f"{xv_err:.3e} {'ok' if codes and xv_ok else 'FAIL'}", flush=True)
        if not (codes and xv_ok):
            raise SystemExit(f"prologue rotate branch disagrees at M={m} K={k} R={r}")
        worst["fused_prologue"] = max(worst["fused_prologue"], xv_err)
        if xd is bf16:
            t_r = time_ms(lambda: prologue.fused_prologue(x, v, 4, 0.9, rotate=True), flush)
            t_u = time_ms(lambda: prologue.fused_prologue(x, v, 4, 0.9), flush)
            t_p = time_ms(lambda: prologue.fused_prologue_plain(x, v, 4, 0.9, rotate=True),
                           flush)
            b, by = _bound(2 * m * k + 2 * k * r + m * k + 4 * m + 4 * m * r,
                           f32_ops=2 * m * k * r + 3 * m * k + m * k * _log2(k))
            timed[("fused_prologue", m, k, r)] = (t_r, t_u, t_p, b, by)
            print(f"      rotated {t_r * 1e3:.2f} us  unrotated {t_u * 1e3:.2f} us  plain "
                  f"{t_p * 1e3:.2f} us  bound {b * 1e3:.3f} us ({by})", flush=True)
    return worst, timed


# decode attention shapes: (batch, heads, kv heads, head_dim, page, pages per
# row, lengths).  The serve shapes are the engine's in phases 4, 6 and 8
# (SLOTS rows, max_seq 64), with one inactive row; the long one is a ragged
# Phi-3-mini batch at up to 4096 tokens; the last has Gemma-7b's heads
# (16/16, head_dim 256), whose prefill phase 14 serves through the dense
# kernels at D 256.
ATTN_SHAPES = {
    "smollm-serve": (SLOTS, 9, 3, 64, PAGE, 4, (64, 37, 13, 0)),
    "phi3-serve": (SLOTS, 32, 32, 96, PAGE, 4, (64, 37, 13, 0)),
    "phi3-long": (SLOTS, 32, 32, 96, PAGE, 256, (4096, 3000, 1024, 17)),
    "gemma-d256": (SLOTS, 16, 16, 256, PAGE, 4, (64, 37, 13, 0)),
}
ATTN_POOLS = {"paged_flash_attention": ("f32", "bf16"),
              "paged_flash_attention_quant": ("int8", "int4-g32")}
# a head dim whose rows hold no whole 16-byte vectors (D·4 and D·2 bytes,
# D int8 codes), so the kernels take their element-wise reader, over three
# splits (MPB 40), on the f32 and bf16 pools and the per-head int8 pool
ATTN_ODD = {"odd-d100": (SLOTS, 4, 2, 100, PAGE, 40, (600, 37, 13, 0))}
ATTN_ODD_POOLS = {"paged_flash_attention": ("f32", "bf16"),
                  "paged_flash_attention_quant": ("int8",)}


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

    from repro_torch.bench.common import time_ms
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
    return time_ms(lambda: F.scaled_dot_product_attention(
        ql, kl, vl, attn_mask=mask, scale=scale), flush)


def _attn_alone(args, row):
    """Row ``row`` of a paged problem alone (B 1), its pages copied to the
    end of a copy of the pool (the old places keep their contents): the
    kernel's arguments."""
    import torch

    quant = len(args) == 9
    ti = 5 if quant else 3
    bt, lengths = args[ti], args[ti + 1]
    page = args[1].shape[1]
    need = -(-int(lengths[row]) // page)
    old = bt[row, :need].long()
    n_pages = args[1].shape[0]
    table = torch.zeros_like(bt[row:row + 1])
    table[0, :need] = n_pages + torch.arange(need, device=bt.device, dtype=bt.dtype)
    pools = [torch.cat([t, t[old]]) for t in args[1:ti]]
    return (args[0][row:row + 1], *pools, table, lengths[row:row + 1], *args[ti + 2:])


def _attn_invariance(device):
    """The split-KV body's invariance, bitwise, fatal: phi3-long's
    4096-token row alone (B 1, its pages placed elsewhere) equals the same
    row in the ragged batch; phi3-serve's rows in a table of MPB 4 (S 1)
    equal them in a table of MPB 256 (S 16), for every pool of both
    kernels."""
    import torch

    from repro_torch.kernels import flash_attn

    for name, pools in ATTN_POOLS.items():
        kern = getattr(flash_attn, name)
        ti = 5 if name.endswith("quant") else 3
        for pool in pools:
            args, _, _, lengths = _attn_problem(ATTN_SHAPES["phi3-long"], pool, device, 40)
            row = int(torch.argmax(lengths))
            n_row = int(lengths[row])
            y = kern(*args)[row]
            y_alone = kern(*_attn_alone(args, row))[0]
            args, _, _, lengths = _attn_problem(ATTN_SHAPES["phi3-serve"], pool, device, 41)
            wide = torch.zeros((SLOTS, 256), dtype=torch.int32, device=device)
            wide[:, :args[ti].shape[1]] = args[ti]
            y4 = kern(*args)
            y256 = kern(*args[:ti], wide, *args[ti + 1:])
            torch.cuda.synchronize()
            live = lengths > 0
            alone = torch.equal(y, y_alone)
            mpb = torch.equal(y4[live], y256[live])
            print(f"  {name:<28} {pool:<9} row of {n_row} alone == in batch: "
                  f"{alone}; MPB 4 (S {flash_attn.paged_splits(4)}) == MPB 256 (S "
                  f"{flash_attn.paged_splits(256)}) for lengths {ATTN_SHAPES['phi3-serve'][6]}: "
                  f"{mpb}", flush=True)
            if not (alone and mpb):
                raise SystemExit(f"{name} {pool}: a row's output depends on its batch, its "
                                 f"pages' places or MPB")


def phase_attention_kernels(device):
    """Both paged attention kernels against their plain versions within
    ``flash_attn.paged_attention_bound`` at every shape of ATTN_SHAPES and
    each pool of ATTN_POOLS, timed (median of 30, L2 flushed), with their
    bytes bound and, for the float kernel, the library call; the odd-width
    case of ATTN_ODD (element-wise reader, S 3); then the bitwise
    invariance gates."""
    import torch

    from repro_torch.bench.common import flush_buffer, time_ms
    from repro_torch.kernels import flash_attn

    flush = flush_buffer(device)
    worst = {name: 0.0 for name in ATTN_POOLS}
    timed = {}
    cases = [(ATTN_SHAPES, ATTN_POOLS), (ATTN_ODD, ATTN_ODD_POOLS)]
    for name in ATTN_POOLS:
        kern = getattr(flash_attn, name)
        plain = getattr(flash_attn, name + "_plain")
        si = 0
        for shapes, pool_sets in cases:
            for label, shape in shapes.items():
                si += 1
                for pool in pool_sets[name]:
                    args, dense, spec, lengths = _attn_problem(shape, pool, device,
                                                               seed=9 + si)
                    y = kern(*args)
                    torch.cuda.synchronize()
                    y_plain = plain(*args)
                    ok_rows = lengths > 0
                    tol = flash_attn.paged_attention_bound(args[0], *dense, lengths,
                                                           shape[3] ** -0.5, shape[4], y_plain)
                    err = (y.double() - y_plain.double()).abs()
                    ok = (bool(torch.isfinite(y[ok_rows]).all())
                          and bool((err[ok_rows] <= tol[ok_rows]).all()))
                    e = err[ok_rows].max().item()
                    r = (err[ok_rows] / tol[ok_rows]).max().item()
                    print(f"  {name:<28} {label:<13} {pool:<9} lengths {shape[6]} S "
                          f"{flash_attn.paged_splits(shape[5])} max_abs_err={e:.3e} "
                          f"worst err/limit={r:.3e} {'ok' if ok else 'FAIL'}", flush=True)
                    if not ok:
                        raise SystemExit(f"{name} disagrees with its plain version at "
                                         f"{label} {pool}")
                    worst[name] = max(worst[name], e)
                    t_k = time_ms(lambda: kern(*args), flush)
                    t_p = time_ms(lambda: plain(*args), flush)
                    b_ms, by = _bound(_attn_bytes(shape, spec),
                                      f32_ops=4 * sum(shape[6]) * shape[1] * shape[3])
                    t_l = (None if spec.is_quantized
                           else _attn_library_ms(args, dense, flush))
                    timed[(name, label, pool)] = (t_k, t_p, b_ms, by, t_l)
                    print(f"    kernel {t_k * 1e3:9.2f} us  plain {t_p * 1e3:10.2f} us  "
                          f"bound {b_ms * 1e3:8.3f} us ({by})  library "
                          + ("null (no PyTorch call attends over a quantized pool)"
                             if t_l is None else f"{t_l * 1e3:.2f} us (SDPA, dense view)"),
                          flush=True)
                    del args, dense, y, y_plain
    _attn_invariance(device)
    return worst, timed


# dense causal attention shapes (batch, seq, heads, kv heads, head_dim,
# dtype): the SmolLM-135M calibration walk of phase 9 (32 x 2048 tokens),
# Phi-3-mini's heads at 4 x 2048, a ragged S and S = 1, and the benchmark
# model of phase 16 (head_dim 32): an evaluation batch of 8 x 64 and the
# calibration walk over 24 x 96 tokens
FLASH_SHAPES = {
    "bench-eval": (8, 64, 4, 2, 32, "float32"),
    "bench-calib": (24, 96, 4, 2, 32, "float32"),
    "smollm-calib": (32, 2048, 9, 3, 64, "float32"),
    "phi3-f32": (4, 2048, 32, 32, 96, "float32"),
    "phi3-bf16": (4, 2048, 32, 32, 96, "bfloat16"),
    "ragged-200": (3, 200, 9, 3, 64, "float32"),
    "ragged-200-bf16": (2, 200, 32, 32, 96, "bfloat16"),
    "s1": (4, 1, 32, 32, 96, "bfloat16"),
}


def _flash_tolerance(q, k, v, scale, y_plain, q_start=0):
    """Elementwise bound on |kernel - plain| of dense causal attention, the
    accuracy standard of the tensor-core body (derived at the head of
    ``csrc/flash_attention.cuh``, stated before its first card run and never
    fitted to measured errors; phase 3's probe checks its two premises).
    Both versions take the same f32 steps on the same 128-row key tiles; the
    kernel's two products run as three TF32 passes (hi·hi apart from the
    cross terms) of m16n8k8 mmas, n = ceil(D/8) of them per pass and score.

    * Premise 1, the split (``flash_attn.tf32_split``, ``cvt.rna.tf32``):
      a product errs by at most 12(1 + 2⁻¹⁰)·u·|a·b| (u = 2⁻²⁴).
    * Premise 2, each mma: within (k + 1)·2⁻²³ = 18u (k = 8) of its largest
      addend.
    * So a kernel score is within (18n + 13)(1 + 2⁻⁸)·u·S of the exact one,
      and the plain version's within D·u·S, S = Σ_d |q_d·scale|·max_keys
      |k_d|: |kernel - plain| <= δ = (18n + 13 + D)(1 + 2⁻⁸)·u·S per score
      (the CUDA-core body's bound was 2·D·u·S), which moves the output by at
      most 2·δ·max|v|.
    * The sums over a row's N = qpos + 1 keys in ``tiles`` = ceil(N / 128)
      tiles (query row i at qpos = q_start + i): the plain version's Σp
      and p·V, and the kernel's Σp (f32 on the CUDA cores), each err by at
      most (N + 2·tiles + 4)·u relative; the kernel's p·V (16 mmas a pass
      per tile) by ((18·16 + 13)(1 + 2⁻⁸) + 2·tiles + 4)·u; each moves the
      output by that times max|v| of the kv head.

    The bound before the tensor cores was 2·max|v|·(2·D·u·S + 2·(N +
    2·tiles + 4)·u).  A bf16 output adds one bf16 ulp of the larger side
    (at most 2⁻⁶ of the plain value's magnitude).  k and v are the values
    the kernel attends over (for a quantized pool, its codes
    dequantized)."""
    import math

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
    n = q_start + torch.arange(1, sq + 1, dtype=f64, device=q.device)[None, :, None]
    tiles = torch.ceil(n / 128)
    score = (18 * math.ceil(d / 8) + 13 + d) * (1 + 2.0 ** -8) * u * s_max
    sums = (3 * (n + 2 * tiles + 4) + (18 * 16 + 13) * (1 + 2.0 ** -8) + 2 * tiles + 4) * u
    tol = (vmax * (2 * score + sums))[..., None]
    if y_plain.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -6 * y_plain.double().abs()
    return tol


def _flash_bound(shape):
    """Least time of one causal call on an H100 SXM (ms), what bounds it,
    and the CUDA-core bound beside it: q, k, v and the output moved once
    each, or the 4·B·H·D·S(S+1)/2 f32 operations of the causal products as
    three TF32 passes at 495 TFLOP/s (the kernel's arithmetic); the last
    value counts the same operations at the non-tensor f32 rate."""
    b, s, h, kh, d, dtype = shape
    item = 4 if dtype == "float32" else 2
    nbytes = item * b * s * d * (2 * h + 2 * kh)
    ops = 4 * b * h * d * s * (s + 1) // 2
    return (*_bound(nbytes, tf32_ops=3 * ops), _bound(nbytes, f32_ops=ops)[0])


def _tensor_core_instructions(names, opcode="HMMA"):
    """The count of tensor-core instructions (``opcode``: HMMA for floating
    point, IMMA for integer operands) in each built library's SASS
    (``cuobjdump -sass``)."""
    from repro_torch.kernels import build

    cuobjdump = str(Path(build.nvcc_path()).parent / "cuobjdump")
    out = {}
    for name in names:
        sass = subprocess.run([cuobjdump, "-sass", str(build.target(name))],
                              capture_output=True, text=True, check=True).stdout
        out[name] = sum(opcode in line for line in sass.splitlines())
    return out


def _gemm_plan_cases():
    """(M, K, N, group) of the GEMM kernel's plan gate: Phi-3-mini's and
    Gemma-7b's sites at the served and prefill M, per-token and at g 128,
    phase 12's sizes, and ragged shapes."""
    from repro_torch.bench.latency_kernels import PHI3_WD, SIZES

    gemma = [(3072, 4096), (4096, 3072), (3072, 24576), (24576, 3072)]
    sites = sorted(set((k, n) for (k, n, _) in PHI3_SITES.values())) + gemma
    cases = [(m, k, n, g) for (k, n) in sites + list(SIZES) + [PHI3_WD]
             for m in (1, SLOTS, CHUNK, 17, 100, 256, 2048) for g in (None, 128)]
    return cases + [(17, 200, 97, None), (3, 90, 33, None), (1, 3072, 3073, None),
                    (33, 8194, 1, None), (5, 16384, 130, None), (4, 200, 33, 8),
                    (4, 200, 33, 10), (100, 90, 33, 45), (4, 3072, 3073, 3072)]


def _prologue_plan_cases():
    """(M, K, R, rotate, x bytes, V bytes) of the prologue's plan gate: the
    served Phi-3-mini and Gemma-7b sites at the decode, prefill-chunk and
    long-prompt-chunk M, phase 12's sizes and ranks, rotated where K is a
    power of two, f32 operands, and ragged shapes."""
    from repro_torch.bench.latency_kernels import MS, PHI3_WD, RANKS, SIZES

    served = [(3072, 307), (8192, 307), (3072, 409), (24576, 307), (8192, 922)]
    cases = [(m, k, r, False, 2, 2) for (k, r) in served
             for m in (1, SLOTS, CHUNK, 17, 100, 777, 2048)]
    cases += [(m, k, r, rot, 2, 2) for m in MS for (k, _) in SIZES + [PHI3_WD]
              for r in RANKS + [307] for rot in (False, True) if not rot or not k & (k - 1)]
    cases += [(m, k, r, rot, xb, vb) for (m, k, r) in ((5, 16384, 40), (20, 1030, 1024),
                                                     (2048, 8192, 922), (7, 256, 33))
              for rot in (False, True) if not rot or not k & (k - 1)
              for (xb, vb) in ((4, 4), (4, 2), (2, 4))]
    return cases + [(17, 200, 7, False, 2, 2), (3, 90, 0, False, 2, 2), (33, 8194, 5, False, 2, 2),
                    (1, 3072, 3073, False, 2, 2), (4, 200, 33, False, 4, 4),
                    (100, 90, 33, False, 4, 4), (2048, 8, 3, True, 2, 2)]


def _fused_plan_cases():
    """(M, K, N, R, group, rotate, x bytes, factor bytes) of the fused
    kernel's plan gate: SmolLM-135M's sites at M 1, 4, 16, 17, 100 and 2048,
    per token and at g 64, rotated where K is a power of two, the f32
    operands and ragged shapes of phases 3 and 13, the widest ranks the
    admission rule takes."""
    shapes = sorted(set(SITES.values()))
    cases = [(m, k, n, r, g, False, 2, 2) for (k, n, r) in shapes
             for m in (1, SLOTS, CHUNK, 17, 100, 2048) for g in (None, SMOL_GROUP)]
    cases += [(m, k, n, r, g, True, 2, 2) for (k, n, r) in ROT_FUSED_SITES for m in (SLOTS, 100)
              for g in (None, 128)]
    return cases + [(17, 200, 97, 7, None, False, 2, 2), (3, 90, 33, 0, None, False, 2, 2),
                    (1, 576, 577, 58, None, False, 2, 2), (33, 1536, 1, 5, None, False, 2, 2),
                    (5, 256, 130, 40, None, False, 4, 4), (16, 576, 64, 58, None, False, 4, 2),
                    (4, 200, 97, 7, 10, False, 4, 4), (100, 90, 33, 0, 45, False, 4, 4),
                    (4, 26, 40, 1024, None, False, 2, 2), (16, 1024, 64, 100, 8, True, 2, 4),
                    (4, 1024, 64, 1, 1, True, 4, 4)]


def phase_fused_build():
    """Phase 2's gates of the fused kernel (#1): ``fused_gemm.fused_plan`` and
    ``fused_gemm.smem_bytes`` equal to the source's plan and footprint at
    ``_fused_plan_cases``; integer tensor-core (IMMA) instructions and no
    DP4A in its SASS; its registers and spills printed."""
    import torch

    from repro_torch.kernels import build, fused_gemm

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = fused_gemm._lib("fused_w4a4_lrc")
    cases = _fused_plan_cases()
    for case in cases:
        m, k, n, r, g, rot, xb, fb = case
        want = fused_gemm.source_plan(m, k, n, r, g, rot, xb, fb, sms)
        if fused_gemm.fused_plan(m, k, n, r, g, rot, xb, fb, sms) != want:
            raise SystemExit(f"fused_gemm.fused_plan{case} is not the source's {want}")
        want = lib.fused_w4a4_lrc_smem_bytes(k, r, g or 0, int(rot), int(xb == 2), int(fb == 2))
        if fused_gemm.smem_bytes(k, r, g, rot, xb, fb) != want:
            raise SystemExit(f"fused_gemm.smem_bytes{(k, r, g, rot, xb, fb)} is not the "
                             f"source's {want}")
    print(f"  fused_gemm.fused_plan and smem_bytes == the source's at {len(cases)} shapes "
          f"({sms} SMs); SmolLM wq at M {SLOTS}: "
          f"{fused_gemm.fused_plan(SLOTS, 576, 576, 58, None, False, 2, 2, sms)}", flush=True)
    imma = _tensor_core_instructions(("fused_w4a4_lrc",), "IMMA")["fused_w4a4_lrc"]
    dp4a = _tensor_core_instructions(("fused_w4a4_lrc",), "DP4A")["fused_w4a4_lrc"]
    print(f"  fused_w4a4_lrc SASS: {imma} IMMA (integer tensor-core) instructions, {dp4a} DP4A",
          flush=True)
    if not imma or dp4a:
        raise SystemExit("the fused kernel's SASS must hold IMMA and no DP4A")
    lines = build.BUILD_LOG.get("fused_w4a4_lrc", "").splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line or "fused_w4a4_lrc_kernel" not in line:
            continue
        entry = line.split("fused_w4a4_lrc_kernel")[1].split("EEvNS")[0]
        regs = next((ln.split(":")[-1].strip() for ln in lines[i + 1:i + 4] if "registers" in ln),
                    "?")
        spill = next((ln.strip() for ln in lines[i + 1:i + 4] if "spill" in ln), "?")
        print(f"  fused_w4a4_lrc_kernel{entry}: {regs}; {spill}", flush=True)


def _act_quant_plan_cases():
    """(M, K, group, x bytes, aligned) of the quantizer's plan gate: the
    served models' site K (SmolLM-135M, Phi-3-mini, Gemma-7b) and phase 12's,
    at M 1 to 2048, per token and at g 64 and 128 where they divide K, f32
    and bf16 x, aligned or not (the element-wise reader), and the ragged
    shapes of phases 3 and 13, a row staged in shared memory among them."""
    from repro_torch.bench.latency_kernels import SIZES
    from repro_torch.kernels import actquant

    ks = sorted({k for (k, _, _) in list(SITES.values()) + list(PHI3_SITES.values())}
                | {k for (k, _) in SIZES} | {24576})
    cases = [(m, k, g, xb, al) for k in ks for m in (1, SLOTS, CHUNK, 100, 2048)
             for g in (None, SMOL_GROUP, PHI3_GROUP) if g is None or k % g == 0
             for xb in (2, 4) for al in (True, False)]
    return cases + [(33, 8194, None, 2, True), (5, 16384, None, 4, True),
                    (3, 90, None, 2, True), (17, 200, 8, 2, True), (4, 200, 10, 4, True),
                    (100, 90, 45, 4, True), (4, 3072, 3072, 2, True), (2, 40000, None, 2, True),
                    (2, actquant.MAX_K, None, 4, False)]


def phase_quant_build():
    """Phase 2's gates of the quantizer (#4) and the transform (#5), fatal:
    ``actquant.act_quant_plan`` equal to the source's plan at
    ``_act_quant_plan_cases``, ``hadamard.fwht_plan`` to the source's at
    every power of two up to MAX_D, f32 and bf16; every instantiation's
    registers and spills printed."""
    from repro_torch.kernels import actquant, hadamard

    cases = _act_quant_plan_cases()
    for case in cases:
        want = actquant.source_plan(*case)
        if actquant.act_quant_plan(*case) != want:
            raise SystemExit(f"actquant.act_quant_plan{case} is not the source's {want}")
    if actquant._lib("act_quant").act_quant_max_k() != actquant.MAX_K:
        raise SystemExit("actquant.MAX_K is not the source's widest row")
    print(f"  actquant.act_quant_plan == the source's plan at {len(cases)} shapes; Phi-3 wd "
          f"at M {SLOTS}: {actquant.act_quant_plan(SLOTS, 8192, None, 2)}", flush=True)
    widths = [2 ** e for e in range(_log2(hadamard.MAX_D) + 1)]
    for d in widths:
        for xb in (2, 4):
            want = hadamard.source_plan(d, xb)
            if hadamard.fwht_plan(d, xb) != want:
                raise SystemExit(f"hadamard.fwht_plan({d}, {xb}) is not the source's {want}")
    p = hadamard.fwht_plan(8192, 2)
    print(f"  hadamard.fwht_plan == the source's plan at D 1..{hadamard.MAX_D}, f32 and bf16; "
          f"D 8192 bf16: {p.threads} threads, {p.chunks} loads a thread, {p.exchanges} "
          f"exchange, sweeps (h, stage, registers 0 / lanes 1, bit) {p.steps}", flush=True)
    for name in ("act_quant", "fwht"):
        for entry, regs in _kernel_registers(name):
            print(f"  {name} {entry}: {regs}", flush=True)


def _kernel_registers(name):
    """(entry, 'registers, spills') of each kernel entry in ``name``'s last
    build log (``nvcc -Xptxas -v``)."""
    from repro_torch.kernels import build

    lines = build.BUILD_LOG.get(name, "").splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line:
            continue
        entry = line.split("'")[1]
        for kind in ("stream_kernel", "tiled_kernel", "rotate_kernel", "held_kernel",
                     "staged_kernel", "fwht_kernel"):
            if kind in entry:
                entry = kind + entry.split(kind)[1].split("EEvNS")[0].split("EEv")[0]
        regs = next((ln.split(":")[-1].split(",")[0].strip() for ln in lines[i + 1:i + 4]
                     if "registers" in ln), "?")
        spill = next((ln.strip() for ln in lines[i + 1:i + 4] if "spill" in ln), "?")
        out.append((entry, f"{regs}; {spill}"))
    return out


# the premises' probe: values whose TF32 rounding is known (ties at the 11th
# significand bit both ways and both signs, a carry into the exponent, the
# largest normals, the smallest normal, pi), and one value on each side of
# a tie; subnormals are printed and held to the split's underflow floor
TF32_PROBE_VALUES = (
    1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11), -(1 + 3 * 2 ** -11),
    1 + 2 ** -11 + 2 ** -23, 1 + 2 ** -11 - 2 ** -23, 2 - 2 ** -23, 2 - 2 ** -12,
    3.141592653589793, -0.1, 1e-3, 65504.0, 3.0e38, 2 ** -126, 0.0, -0.0,
)
TF32_PROBE_SUBNORMAL = (2 ** -140, 3 * 2 ** -149, -1e-40)


def phase_tc_probe(device):
    """Phase 3's probe of the two premises of the dense kernels' accuracy
    standard (``csrc/flash_attention.cuh``, ``_flash_tolerance``), fatal:

    * premise 1: the kernels' split (an integer add and mask) and the same
      split by ``cvt.rna.tf32.f32`` of each value of TF32_PROBE_VALUES and
      of 65,536 random f32 bit patterns of every normal exponent, both
      bitwise ``flash_attn.tf32_split`` (round to nearest, ties away from
      zero, 13 low bits cleared), hi and lo TF32 values, |x - hi - lo| <=
      2⁻²²|x| + 2⁻¹³⁷ (a residual below 2⁻¹²⁶ is subnormal); the subnormals
      of TF32_PROBE_SUBNORMAL within 2⁻¹³⁷ (printed either way);
    * premise 2: rows of one m16n8k8 TF32 mma on chosen addends (1 plus
      tiny products, which round-to-nearest would round up; a 3/4-ulp
      addend on each sign; cancelling sums; a wide spread; exact products;
      zero products onto a nonzero C), each output within (k + 1)·2⁻²³ of
      its largest addend of the exact sum.  What the card does is printed:
      each result beside the exact sum and f32 round-to-nearest's, and
      whether zero products leave C bitwise unchanged."""
    import torch

    from repro_torch.kernels import flash_attn

    f32 = torch.float32
    chosen = TF32_PROBE_VALUES + TF32_PROBE_SUBNORMAL
    gen = torch.Generator().manual_seed(0)
    sign_mant = torch.randint(0, 2 ** 23, (2, 65536), generator=gen, dtype=torch.int32)
    expo = torch.randint(1, 254, (65536,), generator=gen, dtype=torch.int32)
    rand = ((sign_mant[0] & 1) << 31 | expo << 23 | sign_mant[1]).view(f32)
    x = torch.cat([torch.tensor(chosen, dtype=f32), rand]).to(device)
    zeros = [torch.zeros(shape, dtype=f32, device=device) for shape in ((16, 8), (8, 8), (16, 8))]
    hi, lo, hi_cvt, lo_cvt, _ = (t.cpu() for t in flash_attn.tc_probe(x, *zeros))
    want_hi, want_lo = flash_attn.tf32_split(x.cpu())
    normal = torch.ones(x.numel(), dtype=torch.bool)
    normal[len(TF32_PROBE_VALUES):len(chosen)] = False
    bits = lambda t: t.view(torch.int32)  # noqa: E731
    same = {name: (torch.equal(bits(h[normal]), bits(want_hi[normal]))
                   and torch.equal(bits(l[normal]), bits(want_lo[normal])))
            for name, h, l in (("kernel", hi, lo), ("cvt.rna", hi_cvt, lo_cvt))}
    resid = (x.cpu().double() - hi.double() - lo.double()).abs()
    normal_ok = (all(same.values()) and not bool((bits(hi) & 0x1FFF).any())
                 and not bool((bits(lo) & 0x1FFF).any())
                 and bool((resid[normal] <= 2.0 ** -22 * x.cpu()[normal].double().abs()
                           + 2.0 ** -137).all()))
    sub_ok = bool((resid[~normal] <= 2.0 ** -137).all())
    for i, v in enumerate(chosen):
        print(f"    split {v!r:>24}: hi {hi[i].item()!r} lo {lo[i].item()!r} (cvt.rna "
              f"{hi_cvt[i].item()!r} / {lo_cvt[i].item()!r}; emulation "
              f"{want_hi[i].item()!r} / {want_lo[i].item()!r}); |x - hi - lo| "
              f"{resid[i].item():.3e}", flush=True)
    print(f"  premise 1 (round to nearest, ties away): on {int(normal.sum())} normal values "
          f"the kernels' split bitwise the emulation: {same['kernel']}, cvt.rna.tf32.f32's: "
          f"{same['cvt.rna']}; all within 2^-22|x| + 2^-137: {normal_ok}; subnormals within 2^-137: "
          f"{sub_ok}", flush=True)

    # premise 2: each row r of A against B's column 0 (all ones) gives
    # D[r, 0] = C[r, 0] + Σ_k A[r, k]; column 1 holds 1 + 2^-10 in its first
    # row, so D[r, 1] = C[r, 1] + A[r, 0]·(1 + 2^-10) (one product of two
    # 11-bit significands, exact in f32 at "exact products"); columns 2-7
    # are zeros, so D[r, j > 1] = C[r, j] plus zero products
    t = 2.0 ** -24
    ulp1 = 2.0 ** -23
    rows = {
        "1 + 8 x 2^-24": (1.0, [t] * 8),
        "1 + 3/4 ulp": (1.0, [0.75 * ulp1] + [0.0] * 7),
        "-1 - 3/4 ulp": (-1.0, [-0.75 * ulp1] + [0.0] * 7),
        "1 + 1/2 ulp + tiny": (1.0, [0.5 * ulp1, 2.0 ** -40] + [0.0] * 6),
        "cancel: 1 - 1 + 2^-20 + 2^-30": (1.0, [-1.0, 2.0 ** -20, 2.0 ** -30] + [0.0] * 5),
        "spread: 0 + 1 + 7 x 2^-25": (0.0, [1.0] + [2.0 ** -25] * 7),
        "2^24 + 8 x 1": (2.0 ** 24, [1.0] * 8),
        "exact products": (0.0, [1 + 2 ** -10] + [0.0] * 7),
        "alternating": (0.5, [1.0, -1.0 + ulp1, 2.0 ** -22, -(2.0 ** -22), 3.0, -3.0,
                              2.0 ** -30, 0.0]),
        "0 onto C = 1 + 2^-23": (1 + ulp1, [0.0] * 8),
        "-0 onto C = -(1 + 2^-23)": (-(1 + ulp1), [-0.0] * 8),
        "0 onto C = 1/3": (1 / 3, [0.0] * 8),
        "0 onto C = 2^-120 x 1.7": (2.0 ** -120 * 1.7, [0.0] * 8),
        "0 onto C = 0": (0.0, [0.0] * 8),
        "mixed: 1/3 + 8 x 1/7": (1 / 3, [1 / 7] * 8),
        "large: 3e38 - 3e38 + 1": (1.0, [3.0e38, -3.0e38] + [0.0] * 6),
    }
    a = torch.zeros((16, 8), dtype=f32)
    c = torch.zeros((16, 8), dtype=f32)
    for r, (c0, terms) in enumerate(rows.values()):
        c[r, :] = c0
        a[r] = flash_attn.tf32_split(torch.tensor(terms, dtype=f32))[0]  # TF32 values
    bt = torch.zeros((8, 8), dtype=f32)
    bt[0] = 1.0  # B's column 0: ones
    bt[1, 0] = 1 + 2 ** -10
    d = flash_attn.tc_probe(x, a.to(device), bt.to(device), c.to(device))[-1]
    d = d.cpu()
    model_ok, zero_same = True, True
    for r, label in enumerate(rows):
        exact = float(c[r, 0].double() + a[r].double().sum())
        largest = max([abs(float(c[r, 0]))] + [abs(float(v)) for v in a[r]])
        limit = 9 * 2.0 ** -23 * largest
        got = float(d[r, 0])
        rn = torch.tensor(float(c[r, 0]), dtype=f32)
        for v in a[r]:
            rn = rn + v
        prod = float(a[r, 0].double() * (1 + 2 ** -10))
        exact1 = float(c[r, 1].double()) + prod
        ok = (abs(got - exact) <= limit and abs(float(d[r, 1]) - exact1)
              <= 9 * 2.0 ** -23 * max(abs(float(c[r, 1])), abs(prod)))
        same = torch.equal(bits(d[r, 2:]), bits(c[r, 2:]))
        model_ok = model_ok and ok
        zero_same = zero_same and same
        print(f"    mma {label:<30} card {got!r:<24} exact {exact!r:<24} f32 round-to-"
              f"nearest in order {rn.item()!r:<24} |card - exact| {abs(got - exact):.3e} "
              f"<= {limit:.3e}; C + A[0]·(1 + 2^-10): card {float(d[r, 1])!r} exact "
              f"{exact1!r}; within the model: {ok}; zero products onto C bitwise: {same}",
              flush=True)
    print(f"  premise 2 (m16n8k8 TF32 mma): every row within 9 x 2^-23 of its largest "
          f"addend: {model_ok}; zero products leave C bitwise unchanged: {zero_same}",
          flush=True)
    if not (normal_ok and sub_ok and model_ok):
        raise SystemExit("the card breaks a premise of the dense flash kernels' accuracy "
                         "standard (see the probe above): widen the model and restate it")
    return {"split_bitwise": same, "split_within_premise": normal_ok,
            "subnormal_within_floor": sub_ok,
            "mma_within_model": model_ok, "zero_products_keep_c": zero_same,
            "mma": {label: float(d[r, 0]) for r, label in enumerate(rows)}}


def phase_flash_kernels(device):
    """The dense causal flash-attention kernel against its plain version at
    every shape of FLASH_SHAPES, timed (median of 30, L2 flushed) beside
    its bound and ``scaled_dot_product_attention(is_causal=True)`` on an
    expanded-KV copy (the copy made outside the timing)."""
    import torch

    from repro_torch.bench.common import flush_buffer, time_ms
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attn

    flush = flush_buffer(device)
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
        t_k = time_ms(lambda: flash_attn.flash_attention(q, k, v, scale), flush)
        t_p = time_ms(lambda: flash_attn.flash_attention_plain(q, k, v, scale), flush)
        ql, kl, vl = (t.transpose(1, 2).repeat_interleave(h // t.shape[2], dim=1)
                      .contiguous() for t in (q, k, v))
        t_l = time_ms(lambda: F.scaled_dot_product_attention(
            ql, kl, vl, is_causal=True, scale=scale), flush)
        del ql, kl, vl
        b_ms, by, b_cc = _flash_bound(shape)
        timed[label] = (t_k, t_p, b_ms, by, b_cc, t_l)
        print(f"    kernel {t_k * 1e3:10.2f} us  plain {t_p * 1e3:11.2f} us  bound "
              f"{b_ms * 1e3:9.2f} us ({by}; CUDA-core f32 {b_cc * 1e3:.2f} us)  library "
              f"{t_l * 1e3:9.2f} us (SDPA, is_causal, expanded KV)", flush=True)
        del q, k, v, y, y_plain, tol, err
    return worst, timed


# prefill attention over the paged pool: kernel #8 (quantized K/V) at the
# shapes its callers give it, and kernel #7 with a query offset.  Each is
# (batch, query rows, key rows, heads, kv heads, head_dim, q_start, q dtype):
# phase 11's kv_sweep pass (SmolLM-135M's heads, 4 x 2048), Phi-3-mini's
# heads over a whole 2048-token prompt and a 256-row chunk at 1792 of the
# same prompt (phase 10's shapes), each with an f32 q and with the bf16 q
# the served models' bf16 activations give, and a ragged S with a bf16 q
PREFILL_SHAPES = {
    "smollm-b4": (4, 2048, 2048, 9, 3, 64, 0, "float32"),
    "smollm-b4-bf16": (4, 2048, 2048, 9, 3, 64, 0, "bfloat16"),
    "phi3": (1, 2048, 2048, 32, 32, 96, 0, "float32"),
    "phi3-bf16": (1, 2048, 2048, 32, 32, 96, 0, "bfloat16"),
    "phi3-chunk": (1, 256, 2048, 32, 32, 96, 1792, "float32"),
    "phi3-chunk-bf16": (1, 256, 2048, 32, 32, 96, 1792, "bfloat16"),
    "ragged-200": (2, 200, 200, 9, 3, 64, 0, "bfloat16"),
}
# kernel #7 with a query offset over a float pool: (label, whole-prompt
# problem, q_start, query rows, q dtype, K/V dtype).  A served model's bf16
# q over an f32 pool is what every float-pool prefill of phases 4, 6, 9,
# 10 and 11 launches: at Phi-3's chunk, at SmolLM's heads over one serving
# slot's gathered MPB·P = 64 rows (the second 16-row chunk), and at phase
# 11's whole 4 x 2048 call
OFFSET_CASES = (
    ("phi3-chunk", "phi3", 1792, 256, "float32", "float32"),
    ("phi3-chunk", "phi3", 1792, 256, "bfloat16", "bfloat16"),
    ("phi3-chunk", "phi3", 1792, 256, "bfloat16", "float32"),
    ("smollm-serve", "smollm-serve", 16, 16, "bfloat16", "float32"),
    ("smollm-b4", "smollm-b4", 0, 2048, "bfloat16", "float32"),
)
QUANT_POOLS = ATTN_POOLS["paged_flash_attention_quant"]


def _prefill_bound(shape, k_row_bytes, v_row_bytes):
    """Least time of one causal call with a query offset on an H100 SXM (ms),
    what bounds it, and the CUDA-core bound beside it; ``shape`` is (B, Sq,
    Skv, H, KH, D, Dv, q_start, q dtype): q and the output in q's dtype, and
    every K and V row at or before the last query position (``*_row_bytes``
    per kv head: its codes and scales, or its floats) moved once, over 3.35
    TB/s; or the 2·B·H·(D + Dv)·Σ_rows (qpos + 1) f32 operations (2·D for
    the score and 2·Dv for p·V per row and key at or before it) as three
    TF32 passes at 495 TFLOP/s; the last value counts them at the non-tensor
    f32 rate of 67 TFLOP/s."""
    b, sq, skv, h, kh, d, dv, q0, qd = shape
    item = 4 if qd == "float32" else 2
    keys = min(skv, q0 + sq)
    row_keys = sum(min(q0 + i + 1, skv) for i in range(sq))
    nbytes = item * b * sq * h * (d + dv) + b * keys * kh * (k_row_bytes + v_row_bytes)
    ops = 2 * b * h * (d + dv) * row_keys
    return (*_bound(nbytes, tf32_ops=3 * ops), _bound(nbytes, f32_ops=ops)[0])


def _prefill_gate(worst, name, label, pool, y, y_plain, tol, bitwise, rows):
    """The gates of a dense flash kernel's call, fatal: finite, within
    ``tol`` of its plain version, ``bitwise`` (#8 against #7 on the
    dequantized codes) and ``rows`` (a chunk's rows against the whole
    prompt's; None where the call is no chunk); ``worst[name]`` keeps the
    largest error."""
    import torch

    err = (y.double() - y_plain.double()).abs()
    ok = (bool(torch.isfinite(y).all()) and bool((err <= tol).all()) and bitwise
          and rows is not False)
    e = err.max().item()
    print(f"  {name:<21} {label:<16} {pool:<15} max_abs_err={e:.3e} "
          f"limit(min)={tol.min().item():.3e} bitwise-vs-#7(deq) "
          f"{bitwise if name.endswith('quant') else '-'} chunk-rows-bitwise "
          f"{'-' if rows is None else rows} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"{name} failed its gates at {label} {pool}")
    worst[name] = max(worst[name], e)


def _sdpa_timer(q, kd, vd, q0, scale, flush):
    """The time of ``scaled_dot_product_attention`` over a KV-expanded copy
    of K/V in q's dtype (made outside the timing), causal from ``q0``
    (``is_causal`` at 0 over a square problem, else an explicit mask)."""
    import torch

    from repro_torch.bench.common import time_ms
    import torch.nn.functional as F

    b, sq, h, d = q.shape
    g = h // kd.shape[2]
    ql = q.transpose(1, 2).contiguous()
    kl, vl = (t.to(q.dtype).transpose(1, 2).repeat_interleave(g, dim=1).contiguous()
              for t in (kd, vd))
    if q0 == 0 and sq == kd.shape[1]:
        return time_ms(lambda: F.scaled_dot_product_attention(
            ql, kl, vl, is_causal=True, scale=scale), flush)
    mask = (torch.arange(kd.shape[1], device=q.device)[None, :]
            <= q0 + torch.arange(sq, device=q.device)[:, None])
    return time_ms(lambda: F.scaled_dot_product_attention(
        ql, kl, vl, attn_mask=mask, scale=scale), flush)


def phase_prefill_kernels(device):
    """Kernel #8 against its plain version at every shape of PREFILL_SHAPES
    and each pool of QUANT_POOLS, and kernel #7 with a query offset at every
    case of OFFSET_CASES (a bf16 q over f32 K/V among them, as the served
    models launch it); all gates fatal:

    * within ``_flash_tolerance`` of the plain version (the dequantized
      K/V being the values attended over);
    * #8 on codes bitwise #7 on ``dequantize_kv`` of the same codes;
    * the rows of a chunk call (``q_start`` > 0), and the prompt's last
      row asked for alone (a one-token chunk), bitwise the same rows of
      the whole-prompt call over the same K/V.

    Timed (median of 30, L2 flushed) beside the bound, the plain version
    and, for #7, SDPA with an explicit mask; #8 has no library call (no
    PyTorch call attends over quantized K/V): SDPA over a pre-dequantized
    KV-expanded copy is timed as context only."""
    import torch

    from repro_torch.bench.common import flush_buffer, time_ms
    from repro_torch.kernels import flash_attn
    from repro_torch.serve.kvquant import dequantize_kv, quantize_kv

    flush = flush_buffer(device)
    gen = torch.Generator(device=device).manual_seed(4)
    worst = {"flash_attention_quant": 0.0, "flash_attention": 0.0}
    timed, problems, whole = {}, {}, {}

    def problem(label, b, sq, skv, h, kh, d, qd):
        if label not in problems:
            q = torch.randn((b, sq, h, d), generator=gen, device=device).to(getattr(torch, qd))
            k, v = (torch.randn((b, skv, kh, d), generator=gen, device=device) * 1.5
                    for _ in range(2))
            problems[label] = (q, k, v)
        return problems[label]

    for label, shape in PREFILL_SHAPES.items():
        b, sq, skv, h, kh, d, q0, qd = shape
        if q0:  # rows q0… of the whole prompt (the label without "-chunk")
            parent = label.replace("-chunk", "")
            q_all, k, v = problems[parent]
            q = q_all[:, q0:q0 + sq].contiguous()
        else:
            parent = label
            q, k, v = problem(label, b, sq, skv, h, kh, d, qd)
        qs = torch.full((b,), q0, dtype=torch.int32, device=device) if q0 else None
        scale = d ** -0.5
        for pool in QUANT_POOLS:
            spec = _kv_spec(pool)
            (kq, ks), (vq, vs) = quantize_kv(k, spec), quantize_kv(v, spec)
            kd, vd = dequantize_kv(kq, ks, spec, d), dequantize_kv(vq, vs, spec, d)
            args = (q, kq, ks, vq, vs, scale, spec)
            y = flash_attn.flash_attention_quant(*args, q_start=qs)
            y7 = flash_attn.flash_attention(q, kd, vd, scale, q_start=qs)
            torch.cuda.synchronize()
            y_plain = flash_attn.flash_attention_quant_plain(*args, q_start=qs)
            rows = None
            if q0:  # and the prompt's last row on its own
                full = whole[(parent, pool)]
                one = flash_attn.flash_attention_quant(
                    q[:, -1:].contiguous(), *args[1:], q_start=qs + sq - 1)
                rows = (torch.equal(y, full[:, q0:q0 + sq])
                        and torch.equal(one, full[:, q0 + sq - 1:q0 + sq]))
            else:
                whole[(parent, pool)] = y
            _prefill_gate(worst, "flash_attention_quant", label, pool, y, y_plain,
                          _flash_tolerance(q, kd, vd, scale, y_plain, q0),
                          torch.equal(y, y7), rows)
            t_k = time_ms(lambda: flash_attn.flash_attention_quant(*args, q_start=qs), flush)
            t_p = time_ms(lambda: flash_attn.flash_attention_quant_plain(*args, q_start=qs),
                           flush)
            t_c = _sdpa_timer(q, kd, vd, q0, scale, flush)
            row = spec.packed_head_dim(d) + 4 * spec.n_groups(d)
            b_ms, by, b_cc = _prefill_bound((b, sq, skv, h, kh, d, d, q0, qd), row, row)
            timed[("flash_attention_quant", label, pool)] = (t_k, t_p, b_ms, by, b_cc, None,
                                                             t_c)
            print(f"    kernel {t_k * 1e3:10.2f} us  plain {t_p * 1e3:11.2f} us  bound "
                  f"{b_ms * 1e3:9.2f} us ({by}; CUDA-core f32 {b_cc * 1e3:.2f} us)  library "
                  f"none (context: SDPA on a pre-dequantized KV-expanded copy "
                  f"{t_c * 1e3:.2f} us)", flush=True)
            del kq, ks, vq, vs, kd, vd, y, y7, y_plain
    whole.clear()

    # kernel #7 with a query offset, f32 / bf16 pools and a bf16 q over f32
    for label, parent, q0, sq, qd, kvd in OFFSET_CASES:
        if parent == "smollm-serve":  # one slot: 32 prompt rows over 64 gathered
            problem(parent, 1, 2 * sq, 64, 9, 3, 64, "float32")
        q_all, k_all, v_all = problems[parent]
        b, skv, kh, d = k_all.shape[0], k_all.shape[1], k_all.shape[2], k_all.shape[3]
        h = q_all.shape[2]
        qa = q_all.to(getattr(torch, qd))
        k, v = (t.to(getattr(torch, kvd)) for t in (k_all, v_all))
        q = qa[:, q0:q0 + sq].contiguous()
        qs = torch.full((b,), q0, dtype=torch.int32, device=device)
        scale = d ** -0.5
        short = {"float32": "f32", "bfloat16": "bf16"}
        pool = short[kvd] if qd == kvd else f"{short[qd]}q-{short[kvd]}kv"
        y = flash_attn.flash_attention(q, k, v, scale, q_start=qs)
        torch.cuda.synchronize()
        y_plain = flash_attn.flash_attention_plain(q, k, v, scale, q_start=qs)
        rows = None
        if q0:
            y_whole = flash_attn.flash_attention(qa, k, v, scale)
            one = flash_attn.flash_attention(q[:, -1:].contiguous(), k, v, scale,
                                             q_start=qs + sq - 1)
            rows = (torch.equal(y, y_whole[:, q0:q0 + sq])
                    and torch.equal(one, y_whole[:, q0 + sq - 1:q0 + sq]))
            del y_whole
        _prefill_gate(worst, "flash_attention", label, pool, y, y_plain,
                      _flash_tolerance(q, k, v, scale, y_plain, q0), True, rows)
        t_k = time_ms(lambda: flash_attn.flash_attention(q, k, v, scale, q_start=qs), flush)
        t_p = time_ms(lambda: flash_attn.flash_attention_plain(q, k, v, scale, q_start=qs),
                       flush)
        t_l = _sdpa_timer(q, k, v, q0, scale, flush)
        row = k.element_size() * d
        b_ms, by, b_cc = _prefill_bound((b, sq, skv, h, kh, d, d, q0, qd), row, row)
        timed[("flash_attention", label, pool)] = (t_k, t_p, b_ms, by, b_cc, t_l, None)
        print(f"    kernel {t_k * 1e3:10.2f} us  plain {t_p * 1e3:11.2f} us  bound "
              f"{b_ms * 1e3:9.2f} us ({by}; CUDA-core f32 {b_cc * 1e3:.2f} us)  library "
              f"{t_l * 1e3:.2f} us (SDPA, {'is_causal' if q0 == 0 else 'explicit mask'}, "
              f"expanded KV in q's dtype)", flush=True)
        del q, k, v, y, y_plain
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


def serve_prompts(cfg):
    """The served traffic's prompts, as ``repro_torch.launch.serve`` makes
    them."""
    import numpy as np

    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, PROMPT_LEN).astype(np.int32)
            for _ in range(N_REQUESTS)]


def served_launches(cfg, health, n_decode, n_prefill, kernels, names):
    """The launches ``n_decode`` decode and ``n_prefill`` prefill model
    calls of an engine with ``health`` must make, by wrapper name (every
    name in ``names``): each kernel in ``kernels`` once per QLinear call
    (7 a layer), the decode attention kernel once per layer of a decode
    call, the prefill attention kernel once per layer of a prefill call,
    nothing else."""
    expected = {name: 0 for name in names}
    for name in kernels:
        expected[name] = 7 * cfg.n_layers * (n_decode + n_prefill)
    expected[health["decode_attention"]["kernel"]] = cfg.n_layers * n_decode
    expected[health["prefill_attention"]["kernel"]] = cfg.n_layers * n_prefill
    return expected


def phase_serve(cfg, qparams, device, kernels, kv_spec=None, route_ab=False,
                no_memset=False):
    """Serve the traffic through ``ServeEngine.submit``/``run`` with a KV
    pool of ``kv_spec`` (None: f32); every QLinear call must launch each
    kernel named in ``kernels`` once, every decode step's attention the
    spec's paged attention kernel once per layer, every prefill chunk's the
    spec's dense flash kernel (#7 for a float pool, #8 for a quantized one)
    once per layer, and no other kernel or plain version may run.
    ``route_ab`` adds :func:`profile_routes`; ``no_memset`` fails if the
    profiled decode window holds any memset (the fused kernel keeps no
    scratch in device memory, and the chained path's kernels leave their
    tickets at zero: none may precede a launch)."""
    import numpy as np
    import torch

    from repro_torch.serve.engine import Request, RequestState, ServeEngine

    def engine():
        return ServeEngine(cfg, qparams, batch_slots=SLOTS, max_seq=64,
                           page_size=PAGE, prefill_chunk=CHUNK, device=device,
                           kv_spec=kv_spec)

    warm = engine()  # first-use costs (cuBLAS handles, allocator) out of the timing
    warm.submit(Request(rid=0, prompt=serve_prompts(cfg)[0], max_new_tokens=2))
    warm.run()

    eng = engine()
    times = {"prefill": [], "decode": []}
    inner = eng._paged

    def timed(params, tokens, *rest, **kw):
        t = time.perf_counter()
        out = inner(params, tokens, *rest, **kw)
        torch.cuda.synchronize()
        kind = "decode" if tokens.shape == (SLOTS, 1) else "prefill"
        times[kind].append(time.perf_counter() - t)
        return out

    eng._paged = timed
    for i, p in enumerate(serve_prompts(cfg)):
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
    pre = health["prefill_attention"]["kernel"]
    want_attn = cfg.n_layers * eng.counters["decode_calls"]
    want_pre = cfg.n_layers * eng.counters["prefill_calls"]
    expected = served_launches(cfg, health, eng.counters["decode_calls"],
                               eng.counters["prefill_calls"], kernels, counts)
    print(f"  {N_REQUESTS} requests x {NEW_TOKENS} tokens finished; counters "
          f"{eng.counters}", flush=True)
    for site in health["decode_plan"]:
        print(f"  decode_plan: {site}", flush=True)
    print(f"  decode_attention: {health['decode_attention']}; prefill_attention: "
          f"{health['prefill_attention']}; kv: {health['kv']}", flush=True)
    print(f"  model calls {calls}: launches {counts} (want 7 x {cfg.n_layers} "
          f"x {calls} = {want} for {kernels}, {cfg.n_layers} x "
          f"{eng.counters['decode_calls']} decode calls = {want_attn} for {attn}, "
          f"{cfg.n_layers} x {eng.counters['prefill_calls']} prefill calls = "
          f"{want_pre} for {pre}, 0 for the rest)", flush=True)
    if counts != expected:
        raise SystemExit(f"serve: not every QLinear went through {kernels}, or "
                         f"not every decode attention through {attn}, or not "
                         f"every prefill attention through {pre}")
    n_tok = sum(rec.new_tokens for rec in done.values())
    prof = profile_decode(cfg, qparams, device, engine, serve_prompts(cfg))
    if no_memset and prof["memsets_per_step"]:
        raise SystemExit(f"serve: the decode window holds {prof['memsets_per_step']:.0f} "
                         f"memsets a step; the W4A4 paths' kernels launch none")
    if route_ab:
        prof["routes"] = profile_routes(cfg, qparams, device, serve_prompts(cfg), kv_spec)
    stats = {
        "tokens_per_s": n_tok / wall,
        "wall_s": wall,
        "decode_step_ms": statistics.median(times["decode"]) * 1e3,
        "prefill_chunk_ms": statistics.median(times["prefill"]) * 1e3,
        "decode_calls": eng.counters["decode_calls"],
        "prefill_calls": eng.counters["prefill_calls"],
        "kv": health["kv"],
        **prof,
        # the fault-free streams phase 15 holds its runs to (left out of
        # the printed summary)
        "streams": {rid: list(rec.out_tokens) for rid, rec in done.items()},
    }
    print(f"  {n_tok} tokens in {wall:.3f} s = {stats['tokens_per_s']:.1f} tok/s; "
          f"decode step {stats['decode_step_ms']:.2f} ms (median of "
          f"{len(times['decode'])}); prefill chunk {stats['prefill_chunk_ms']:.2f} "
          f"ms (median of {len(times['prefill'])})", flush=True)
    return counts, stats


def profile_decode(cfg, qparams, device, engine, prompts, top=10):
    """Where a decode step's time goes: one decode-only window (SLOTS
    requests already prefilled) under torch.profiler
    (:func:`_device_profile`)."""
    import torch
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
    return _device_profile(prof, wall, steps, "decode steps", top)


def _device_profile(prof, wall, steps, what, top):
    """Device time by kernel of a profiled window of ``steps`` ``what`` (the
    ``top`` largest printed) and the share of the window the card was
    idle.  Only the device's own events (kernels, memsets, copies) are
    summed: a CPU operator's row repeats the device time of the kernels it
    launched, as torch's own table total leaves it out."""
    from torch.autograd import DeviceType

    rows = []
    memsets = 0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA or getattr(evt, "is_user_annotation", False):
            continue
        if "memset" in evt.key.lower():
            memsets += evt.count
        if evt.self_device_time_total > 0:
            rows.append((evt.self_device_time_total, evt.key, evt.count))
    if not rows:
        raise SystemExit("profile: torch.profiler recorded no device time")
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    ops = sum(r[2] for r in rows) / steps
    print(f"  profile: {steps} {what} in {wall * 1e3:.2f} ms wall, device "
          f"busy {busy * 1e3:.2f} ms ({busy / wall:.1%}), idle {1 - busy / wall:.1%}, "
          f"{ops:.0f} device operations a step, {memsets / steps:.0f} memsets a step",
          flush=True)
    for dev_us, key, count in rows[:top]:
        print(f"    {dev_us / steps / 1e3:8.3f} ms/step  x{count // steps:<5} {key[:90]}",
              flush=True)
    return {"profiled_step_ms": wall / steps * 1e3,
            "device_busy_ms_per_step": busy / steps * 1e3,
            "device_idle_share": 1 - busy / wall,
            "device_ops_per_step": ops,
            "memsets_per_step": memsets / steps,
            "top": [{"key": key, "ms_per_step": dev_us / steps / 1e3,
                     "count_per_step": count // steps} for dev_us, key, count in rows[:top]]}


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
    return {route: {k: statistics.mean(r[k] for r in rs) for k in rs[0] if k != "top"}
            for route, rs in runs.items()}


def phase_parity(cfg, qparams, device):
    """One teacher-forced paged_step over SLOTS x CHUNK tokens of the served
    model through the kernel path.

    (a) Every one of its 7 x 30 QLinear calls is held against the kernel's
        plain version on the same activations, to the phase-3 tolerance,
        and bitwise against the chained path (#3 then #2) on them; the
        step run again with every QLinear on the chained path must give
        logits bitwise the fused step's.
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

    def logits_of(impl, ctx=None):
        pool = model.init_paged_cache(cfg, 1 + SLOTS * per, PAGE,
                                      dtype=torch.float32, device=device)
        out, _ = model.paged_step(
            cfg, retag_qlinear_impl(qparams, impl, ctx), tokens, positions, valid,
            pool, block_table)
        out = out.flatten()
        if not torch.isfinite(out).all():
            raise SystemExit(f"parity: non-finite logits from {impl}")
        return out

    site = {"calls": 0, "worst": 0.0, "bad": 0, "not_chained": 0, "shapes": set()}
    ops.fused_w4a4_lrc = _checked_fused(site)
    try:
        kernel = logits_of("pallas")
        ops.fused_w4a4_lrc = fused_gemm.fused_w4a4_lrc_plain
        plain = logits_of("pallas")
    finally:
        ops.fused_w4a4_lrc = fused_gemm.fused_w4a4_lrc
    chained = logits_of("pallas", KernelContext(impl="chained"))
    same = torch.equal(kernel, chained)
    print(f"  (a) {site['calls']} QLinear calls on the served activations: max "
          f"|kernel - plain| {site['worst']:.3e}, {site['bad']} outside the "
          f"tolerance, {site['not_chained']} not bitwise the chained path; the step "
          f"on the chained path: logits {'bitwise' if same else 'NOT bitwise'} the "
          f"fused step's", flush=True)
    if site["calls"] != 7 * cfg.n_layers or site["bad"]:
        raise SystemExit("parity: a QLinear call disagrees with the plain version")
    if site["not_chained"] or not same:
        raise SystemExit("parity: the fused path is not bitwise the chained path")

    int8, sim = logits_of("int8"), logits_of("sim")

    def corr(a, b):
        return torch.corrcoef(torch.stack([a, b]))[0, 1].item()

    rows = {"kernel~int8": (kernel, int8), "sim~int8": (sim, int8),
            "kernel~plain": (kernel, plain)}
    stats = {"site_max_abs_err": site["worst"], "chained_logits_bitwise": same}
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

    from repro_torch.bench.common import gemm_tolerance, xv_tolerance
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

    def checked_prologue(x, v, bits=4, clip_ratio=1.0, rotate=False, group=None):
        xq, sx, xv = prologue.fused_prologue(x, v, bits, clip_ratio, rotate, group)
        xq_p, sx_p, xv_p = prologue.fused_prologue_plain(x, v, bits, clip_ratio, rotate,
                                                         group)
        site["calls"] += 1
        bad = not (torch.equal(xq, xq_p) and torch.equal(sx, sx_p))
        if v is not None:
            err = (xv - xv_p).abs()
            site["xv"] = max(site["xv"], err.max().item())
            bad |= not bool((err <= xv_tolerance(x, v, x.shape[1], xv_p)).all())
        site["bad"] += int(bad)
        return xq, sx, xv

    def checked_quant(x, bits=4, clip_ratio=1.0, group=None):
        xq, sx = actquant.act_quant(x, bits, clip_ratio, group)
        xq_p, sx_p = actquant.act_quant_plain(x, bits, clip_ratio, group)
        site["calls"] += 1
        site["bad"] += int(not (torch.equal(xq, xq_p) and torch.equal(sx, sx_p)))
        return xq, sx

    def checked_gemm(xq, sx, wp, sw, xv=None, u=None, group=None):
        y = w4a4.w4a4_lowrank_matmul(xq, sx, wp, sw, xv, u, group)
        y_p = w4a4.w4a4_lowrank_matmul_plain(xq, sx, wp, sw, xv, u, group)
        err = (y - y_p).abs()
        r = 0 if xv is None else xv.shape[1]
        site["gemm"] = max(site["gemm"], err.max().item())
        site["bad"] += int(not bool((err <= gemm_tolerance(xv, u, r, y_p)).all()))
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
        want["flash_attention"] = cfg.n_layers  # the step's prefill attention
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
        tol = flash_attn.paged_attention_bound(q, *dense, lengths, scale, kp.shape[1],
                                               y_p)
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
# one site per shape class solved on the card and on this machine's CPU, f64
CPU_REL = 1e-8


class StageTimes:
    """Seconds per calibration stage, read by wrapping the functions the
    walk calls (each wrapped call synchronizes the card before and after,
    so the stages do not overlap): the rotation, the statistics, GPTQ,
    ``lrc_solve`` (whose time less GPTQ's is the eigensolves and triangular
    solves), the walk's attention, and the time at the end of each layer.
    Each call's time is kept too (``calls``), so the first call of each
    stage reads apart from the rest; before the walk's clock starts, one
    throwaway ``eigh`` and one GPTQ column are timed (``warm``): a
    one-time library load shows there.  Each LRC solve's result is kept
    (``lrc``: name, result), and for each weight shape of layer 0 its first
    site's weight and statistics (``sites``: shape → (name, w, stats))."""

    def __init__(self):
        self.sec = {"rotation": 0.0, "statistics": 0.0, "gptq": 0.0,
                    "lrc_solve": 0.0, "attention": 0.0}
        self.calls = {stage: [] for stage in self.sec}
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
            dt = time.perf_counter() - t
            self.sec[stage] += dt
            self.calls[stage].append(dt)
            return out
        return wrapped

    def _warm(self, device):
        """One throwaway f64 ``eigh`` and one GPTQ column on the card, each
        timed on its own, before the walk's clock starts."""
        import torch

        from repro_torch.core.gptq import gptq_quantize
        from repro_torch.core.quantizers import QuantSpec

        self.warm = {}
        a = torch.randn((64, 64), dtype=torch.float64, device=device)
        for name, fn in (("eigh", lambda: torch.linalg.eigh(a @ a.T)),
                         ("gptq_column", lambda: gptq_quantize(
                             a[:, :1], (a[:1] @ a[:1].T), QuantSpec(bits=4)))):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            self.warm[name] = time.perf_counter() - t

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

        self._warm(tokens.device)
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
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
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
        # what the calibration itself holds at its peak: the weights of other
        # phases still resident on the card are left out
        self.peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        return out

    def summary(self):
        per_layer = [b - a for a, b in zip([0.0] + self.layers, self.layers)]
        first = {stage: c[0] for stage, c in self.calls.items() if c}
        if self.calls["lrc_solve"] and self.calls["gptq"]:
            # the first LRC solve runs the first GPTQ (one iteration)
            first["eigh_and_solves"] = self.calls["lrc_solve"][0] - self.calls["gptq"][0]
        rest = {stage: statistics.median(c[1:]) for stage, c in self.calls.items()
                if len(c) > 1}
        return {"total_s": self.total, "rotation_s": self.sec["rotation"],
                "statistics_s": self.sec["statistics"], "gptq_s": self.sec["gptq"],
                "eigh_and_solves_s": self.sec["lrc_solve"] - self.sec["gptq"],
                "walk_attention_s": self.sec["attention"],
                "per_layer_s": per_layer, "peak_gb": self.peak_gb,
                "warm_s": self.warm, "first_call_s": first,
                "later_calls_median_s": rest}


def _print_times(label, times):
    per = times["per_layer_s"]
    print(f"  {label}: total {times['total_s']:.2f} s; rotation "
          f"{times['rotation_s']:.3f} s, statistics {times['statistics_s']:.2f} s, "
          f"GPTQ {times['gptq_s']:.2f} s, eigh/solves "
          f"{times['eigh_and_solves_s']:.2f} s, walk attention "
          f"{times['walk_attention_s']:.3f} s; per layer median "
          f"{statistics.median(per):.3f} s (first {per[0]:.3f}, max {max(per):.3f}); "
          f"max_memory_allocated {times['peak_gb']:.2f} GB above what was resident",
          flush=True)
    warm, first, rest = times["warm_s"], times["first_call_s"], times["later_calls_median_s"]
    print(f"  {label} first calls: before the walk, a throwaway eigh {warm['eigh']:.3f} s "
          f"and a GPTQ column {warm['gptq_column']:.3f} s; in the walk, first "
          + ", ".join(f"{stage} {sec:.3f} s" for stage, sec in first.items())
          + "; later calls' median "
          + ", ".join(f"{stage} {sec:.4f} s" for stage, sec in rest.items()), flush=True)


def _check_update_lr(stage):
    """Prop 3.3 at every site: Update-LR does not raise the loss."""
    bad = [(name, r.losses) for name, r in stage.lrc
           if not all(r.losses[i + 1] <= r.losses[i] * (1 + 1e-9)
                      for i in range(0, len(r.losses), 2))]
    if bad:
        raise SystemExit(f"calibration: Update-LR raised the loss at {bad}")


def _loss_change_limit(x, x2, w, w_hat, u, v, spec, eps_frac, chunk=8192):
    """Bound on |L(X2) - L(X)| of one site's reconstruction loss per token
    (``core/lrc.reconstruction_loss``) at a FIXED solution (Ŵ, U, V), for
    the two inputs the walks measured, X and X2 (n, d).  With R = W - U·Vᵀ
    and y = Q_a(x) as ``core/stats.accumulate_stats`` quantizes it, the loss
    is (1/n)·Σ_t ||r_t||², r_t = R·x_t - Ŵ·y_t, plus the damping that
    ``finalize_stats`` adds to Σxx and Σyy, (eps/d)·(Σ_t||x_t||²·||R||²_F +
    Σ_t||y_t||²·||Ŵ||²_F)/n.  Token t's residual moves by Δ_t =
    R·(x2_t - x_t) - Ŵ·(y2_t - y_t), computed (activation code flips
    included), so the first part moves by at most (2/n)·Σ_t ||r_t||·||Δ_t||
    + M, M = mean_t ||Δ_t||², and the damping by exactly
    (eps/d)·|ΔΣ_t||x_t||²·||R||²_F + ΔΣ_t||y_t||²·||Ŵ||²_F|/n.  Returns
    (limit, its terms)."""
    import torch

    from repro_torch.core.quantizers import dequantize_act, quantize_act

    f64 = torch.float64
    r = w.to(f64) - u.to(f64) @ v.to(f64).T
    wh = w_hat.to(f64)
    cross = m = dx = dy = 0.0
    for i in range(0, x.shape[0], chunk):
        xa, xb = x[i:i + chunk].to(f64), x2[i:i + chunk].to(f64)
        ya, yb = (dequantize_act(*quantize_act(t, spec), spec).to(f64) for t in (xa, xb))
        delta = ((xb - xa) @ r.T - (yb - ya) @ wh.T).norm(dim=-1)
        cross += float((2 * (xa @ r.T - ya @ wh.T).norm(dim=-1) * delta).sum())
        m += float((delta ** 2).sum())
        dx += float(xb.square().sum() - xa.square().sum())
        dy += float(yb.square().sum() - ya.square().sum())
    n, d = x.shape
    cross, m = cross / n, m / n
    damp = eps_frac / d * abs(float(r.norm()) ** 2 * dx + float(wh.norm()) ** 2 * dy) / n
    return cross + m + damp, {"cross": cross, "m": m, "damping": damp}


# which of layer 0's collected activations feeds each site (walk order)
SITE_INPUT = {"attn/wq": 0, "attn/wk": 0, "attn/wv": 0, "attn/wo": 1,
              "mlp/wg": 2, "mlp/wu": 2, "mlp/wd": 3}


def _walk_layer0(cfg, rotated, tokens, policy, route, device):
    """Layer 0 of the calibration walk on ``route``, with what it saw: its
    attention calls (q, k, v, scale, out), the activations its statistics
    were collected on (walk order: h, pre_o, h2, hidden), and each LRC
    solve's weight, statistics, result and output power."""
    import torch

    from repro_torch.core.lrc import reconstruction_loss
    from repro_torch.models.transformer import embed_tokens
    from repro_torch.quant import calibrate

    x = embed_tokens(cfg, rotated, tokens).to(torch.float32)
    b, s, _ = x.shape
    positions = torch.arange(s, device=device).expand(b, s)
    walk = {"attention": [], "inputs": [], "solves": []}
    orig = (calibrate.causal_attention, calibrate.lrc_solve, calibrate.collect_stats)

    def capture(q, k, v, scale, route, mask=None):
        out = orig[0](q, k, v, scale, route, mask)
        walk["attention"].append((q, k, v, scale, out))
        return out

    def solve_lrc(w, st, *a, **kw):
        res = orig[1](w, st, *a, **kw)
        walk["solves"].append((w, st, res, reconstruction_loss(w, st)))
        return res

    def stats(acts, *a, **kw):
        walk["inputs"].append(acts.reshape(-1, acts.shape[-1]))
        return orig[2](acts, *a, **kw)

    calibrate.causal_attention, calibrate.lrc_solve, calibrate.collect_stats = (
        capture, solve_lrc, stats)
    try:
        calibrate._dense_layer_walk(cfg, rotated["layers"][0], x, positions, None,
                                    policy, route=route)
    finally:
        calibrate.causal_attention, calibrate.lrc_solve, calibrate.collect_stats = orig
    return walk


def _layer0_routes(cfg, stage, tokens, policy, device):
    """Layer 0 walked again on each attention route, outside the timed
    calibration (the kernel route's walk must repeat the calibration's
    layer 0 losses; it is printed whether it does bitwise).

    (a) The reference route's pre_o against the kernel on the same q, k, v:
        within the kernel's bound against ``attention``
        (``_flash_tolerance`` with the one extra rounding of the
        reference's scale-after-product).  This bound, τ, is how far the
        route may move the walk.
    (b) The seven sites against a limit derived from how far each site's
        input moved: ``_loss_change_limit`` carries the two walks' measured
        inputs through the statistics (the 4-bit activation codes included)
        into the loss's trace terms, at the kernel walk's solution, for each
        loss the solver records (after Update-Q with the initial U, V, and
        after Update-LR).  wq, wk and wv see the same input (the route has
        not entered yet: their limit is 0, and everything must be bitwise);
        wo sees each route's pre_o, whose difference (a) holds within τ;
        wg, wu and wd see inputs that have passed through wo's solution on
        each route.  Gates, for each recorded loss:
        * the fixed-solution change (the kernel walk's solution on the
          gather walk's statistics against on its own) within the limit,
          which it must obey exactly;
        * the limit below the loss (a limit at or above it could not tell
          a wrong loss from a right one);
        and, for the final loss (after Update-LR), the gather walk's own
        re-solved loss within the limit of the kernel walk's.  The walks
        re-solve every site, and no fixed-solution bound covers that: a
        rounding-level change of wo's input turns thousands of GPTQ codes
        the other way, and the Update-Q loss moves with them (printed, not
        gated); Update-LR then fits U, V to each walk's own codes, and the
        final losses are held to the limit."""
    import inspect

    import torch

    from repro_torch.core import stats as stats_lib
    from repro_torch.core.lrc import init_lr, reconstruction_loss
    from repro_torch.core.quantizers import QuantSpec, dequantize_weight
    from repro_torch.kernels import ops

    walks = {route: _walk_layer0(cfg, stage.rotated, tokens, policy, route, device)
             for route in ("kernel", "gather")}
    kw, gw = walks["kernel"], walks["gather"]
    repeat = all(a.losses == res.losses for (_, a), (_, _, res, _) in
                 zip(stage.lrc[:7], kw["solves"]))
    q, k, v, scale, ref = gw["attention"][0]
    kern = ops.flash_attention(q, k, v, scale)
    torch.cuda.synchronize()
    tol = _flash_tolerance(q, k, v, scale, ref)
    # one more rounding per score on the reference's side (scale after the dot)
    tol = tol * (q.shape[-1] + 1) / q.shape[-1]
    err = (kern.double() - ref.double()).abs()
    same_pre_o = torch.equal(kern, kw["attention"][0][4])
    pre_o_ok = bool((err <= tol).all()) and same_pre_o
    print(f"  layer 0, kernel vs reference attention route: pre_o max |diff| "
          f"{err.max().item():.3e} (bound τ min {tol.min().item():.3e}, max "
          f"{tol.max().item():.3e}); the kernel walk's pre_o is this call's "
          f"{'bitwise' if same_pre_o else 'NOT bitwise'} {'ok' if pre_o_ok else 'FAIL'}; "
          f"the kernel walk repeats the calibration's layer-0 losses "
          f"{'bitwise' if repeat else 'not bitwise'}", flush=True)

    spec_a = QuantSpec(bits=policy.act_bits, clip_ratio=policy.clip_ratio)
    eps_frac = inspect.signature(stats_lib.finalize_stats).parameters["eps_frac"].default
    same_h = torch.equal(kw["inputs"][0], gw["inputs"][0])
    sites, bad, blind = {}, [], []
    for (name, _), (w, st, rk, _), (_, st_g, rr, p) in zip(stage.lrc[:7], kw["solves"],
                                                           gw["solves"]):
        j = SITE_INPUT[name]
        xk, xg = kw["inputs"][j], gw["inputs"][j]
        moved = float((xk.double() - xg.double()).abs().max())
        u0, v0 = init_lr(w, st, policy.rank(w.shape[1], w.shape[0]))
        w_hat = dequantize_weight(rk.qweight, rk.scales.double(), spec_a)
        entries = []
        for li, (uu, vv) in enumerate(((u0, v0), (rk.u, rk.v))):
            limit, terms = _loss_change_limit(xk, xg, w, w_hat, uu, vv, spec_a, eps_frac)
            fixed = abs(reconstruction_loss(w, st_g, w_hat, uu, vv)
                        - reconstruction_loss(w, st, w_hat, uu, vv))
            diff = abs(rk.losses[li] - rr.losses[li])
            final = li == len(rk.losses) - 1
            entries.append({"diff": diff, "fixed": fixed, "limit": limit, "gated": final,
                            "of_power": diff / p, "fixed_of_power": fixed / p,
                            "limit_of_power": limit / p,
                            "limit_of_loss": limit / rk.losses[li],
                            "terms_of_power": {k: v / p for k, v in terms.items()}})
            if not fixed <= limit or (final and not diff <= limit):
                bad.append((name, li))
            if not limit < rk.losses[li]:
                blind.append((name, li))
        worst = max(entries, key=lambda t: t["of_power"])
        sites[name] = {"entries": entries, "of_loss": worst["diff"] / min(rr.losses),
                       "of_power": worst["of_power"],
                       "loss_over_power": rr.losses[-1] / p,
                       "input_diff_max": moved}
        print(f"    {name}: input max |diff| {moved:.3e}; of the output power, after "
              f"Update-Q / Update-LR: re-solved |diff| " + " / ".join(
                  f"{t['of_power']:.3e}{'' if t['gated'] else ' (not gated)'}"
                  for t in entries)
              + ", fixed-solution |diff| " + " / ".join(
                  f"{t['fixed_of_power']:.3e}" for t in entries)
              + ", limit " + " / ".join(
                  f"{t['limit_of_power']:.3e} ({t['limit_of_loss']:.2e} of the loss)"
                  for t in entries)
              + f"; loss/power {rr.losses[-1] / p:.4f}; limit terms "
              + ", ".join(f"{k} {v:.3e}" for k, v in entries[-1]["terms_of_power"].items()),
              flush=True)
    worst = max(v["of_power"] for v in sites.values())
    print(f"  site losses max |diff| {worst:.3e} of the output power; every gated change "
          f"within its derived limit: {not bad}; every limit below its loss: {not blind}; "
          f"layer 0's h bitwise on both routes: {same_h}", flush=True)
    del walks, kw, gw
    torch.cuda.empty_cache()
    if not pre_o_ok or bad or blind or not same_h:
        raise SystemExit(f"calibration: the kernel route's layer 0 disagrees with the "
                         f"reference route (outside the derived limit: {bad}; limit not "
                         f"below the loss: {blind})")
    return {"pre_o_max_abs_diff": err.max().item(), "sites": sites,
            "kernel_walk_repeats_losses": repeat}


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
# phase 10: long prompts, prefill over the paged pool through kernels
# ---------------------------------------------------------------------------

# four requests whose prompts span one to sixteen 128-row key tiles, served
# whole and in chunks of 100 rows (a multiple of neither the 64-row query
# tile nor the 128-row key tile), on every pool; max_seq covers the longest
# prompt and its new tokens
LONG_PROMPTS = (2048, 1500, 777, 130)
LONG_MAX_SEQ = 2112
LONG_CHUNKS = (None, 100)
LONG_POOLS = ("f32",) + QUANT_POOLS
# where phase 10 profiles one 100-row chunk of the 2048-token prompt
PROFILED_CHUNK_AT = 1800


def _long_engine(cfg, qparams, device, pool, chunk, route):
    from repro_torch.kernels.context import KernelContext
    from repro_torch.serve.engine import ServeEngine

    return ServeEngine(cfg, qparams, batch_slots=SLOTS, max_seq=LONG_MAX_SEQ,
                       page_size=PAGE, prefill_chunk=chunk, device=device,
                       kv_spec=_kv_spec(pool), ctx=KernelContext(attention=route))


def _serve_long(cfg, qparams, device, prompts, pool, chunk, route):
    """One engine run of the long prompts; returns (streams, stats).  Every
    request must finish with its NEW_TOKENS tokens and the launches must be
    exactly: the chained QLinear kernels 7 x layers per model call; on the
    kernel route the spec's dense flash kernel layers x prefill calls and
    its paged kernel layers x decode calls; nothing else."""
    import torch

    from repro_torch.serve.engine import Request, RequestState

    gc.collect()  # an earlier run's engine (and its pool) is gone before the baseline
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = _long_engine(cfg, qparams, device, pool, chunk, route)
    chunk_s, first = [], []
    inner = eng._paged

    def timed(params, tokens, *rest, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(params, tokens, *rest, **kw)
        torch.cuda.synchronize()
        if tokens.shape[0] == 1:  # a prefill chunk (a decode step has SLOTS rows)
            chunk_s.append(time.perf_counter() - t)
            if not first:  # rid 0's first chunk: its whole prompt when chunk is None
                first.append(out[0][0, -1].float())
        return out

    eng._paged = timed
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS))
    reset_launches()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    label = f"{pool} chunk {chunk} {route} route"
    bad = [r for r, rec in done.items()
           if rec.status is not RequestState.FINISHED or rec.new_tokens != NEW_TOKENS]
    if len(done) != len(prompts) or bad:
        raise SystemExit(f"long prefill ({label}): requests {bad} did not finish: {done}")
    health = eng.health()
    calls = eng.counters["decode_calls"] + eng.counters["prefill_calls"]
    want = {k: 0 for k in counts}
    for name in ("fused_prologue", "w4a4_lowrank_matmul"):
        want[name] = 7 * cfg.n_layers * calls
    if route == "kernel":
        want[health["prefill_attention"]["kernel"]] = cfg.n_layers * eng.counters["prefill_calls"]
        want[health["decode_attention"]["kernel"]] = cfg.n_layers * eng.counters["decode_calls"]
    if counts != want:
        raise SystemExit(f"long prefill ({label}): launches {counts}, want {want}")
    stats = {"wall_s": wall, "prefill_calls": eng.counters["prefill_calls"],
             "decode_calls": eng.counters["decode_calls"],
             "prefill_chunk_ms_median": statistics.median(chunk_s) * 1e3,
             "prefill_chunk_ms_max": max(chunk_s) * 1e3,
             "prefill_s_total": sum(chunk_s), "peak_gb_pool_and_run": peak,
             "bytes_per_token": health["kv"]["bytes_per_token"],
             "prefill_attention": health["prefill_attention"], "launches": counts}
    print(f"  {label:<32} {eng.counters['prefill_calls']:>3} prefill calls, median "
          f"{stats['prefill_chunk_ms_median']:8.2f} ms (max {stats['prefill_chunk_ms_max']:8.2f}), "
          f"prefill total {stats['prefill_s_total']:.3f} s, run {wall:.2f} s; peak "
          f"{peak:.2f} GB above the weights (the pool included); launches ok",
          flush=True)
    return {rid: rec.out_tokens for rid, rec in done.items()}, stats, first[0]


def profile_prefill_chunk(cfg, qparams, device, prompt, pool, route, top=8):
    """One 100-row prefill chunk of ``prompt`` at PROFILED_CHUNK_AT under
    torch.profiler (:func:`_device_profile`): the earlier chunks run first,
    unprofiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import Request

    eng = _long_engine(cfg, qparams, device, pool, LONG_CHUNKS[1], route)
    eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=2))
    eng._admit()
    while eng._prefill_off[0] < PROFILED_CHUNK_AT:
        eng._prefill_tick()
    torch.cuda.synchronize()
    print(f"  profiled chunk: {pool} pool, {route} route, rows {eng._prefill_off[0]}"
          f"…{eng._prefill_off[0] + LONG_CHUNKS[1] - 1}", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng._prefill_tick()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return _device_profile(prof, wall, 1, "prefill chunk", top)


def phase_long_prefill(cfg, qparams, device):
    """Phi-3-mini (phase 6's weights) serving LONG_PROMPTS on each pool of
    LONG_POOLS: on the kernel route whole (chunk None) and in 100-row
    chunks, whose greedy streams must be bitwise equal within each pool;
    on the gather route whole, for the A/B (ms per prefill chunk, peak
    memory, the first sampled token's logits correlation); one chunk of
    each route profiled; bytes per token."""
    import numpy as np
    import torch

    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in LONG_PROMPTS]
    print(f"  {cfg.name}, {cfg.n_layers} layers; prompts {LONG_PROMPTS} x "
          f"{NEW_TOKENS} new tokens, greedy; {SLOTS} slots, page {PAGE}, max_seq "
          f"{LONG_MAX_SEQ}", flush=True)
    out = {}
    for pool in LONG_POOLS:
        streams, runs, first = {}, {}, {}
        for chunk in LONG_CHUNKS:
            streams[chunk], runs[f"kernel/{chunk}"], logits = _serve_long(
                cfg, qparams, device, prompts, pool, chunk, "kernel")
            if chunk is None:  # rid 0's whole prompt in one call
                first["kernel"] = logits
        gather_streams, runs["gather/None"], first["gather"] = _serve_long(
            cfg, qparams, device, prompts, pool, None, "gather")
        same = streams[None] == streams[LONG_CHUNKS[1]]
        agree = sum(a == b for a, b in zip(
            np.concatenate([streams[None][r] for r in sorted(streams[None])]),
            np.concatenate([gather_streams[r] for r in sorted(gather_streams)])))
        c = torch.corrcoef(torch.stack([first["kernel"], first["gather"]]))[0, 1].item()
        print(f"  {pool}: kernel-route streams chunk None vs {LONG_CHUNKS[1]} "
              f"{'bitwise equal' if same else 'DIFFER'}; gather route agrees on {agree} of "
              f"{len(prompts) * NEW_TOKENS} tokens; rid 0's first sampled logits "
              f"kernel~gather correlation {c:.6f}", flush=True)
        if not same:
            raise SystemExit(f"long prefill: {pool} streams depend on the chunk width")
        out[pool] = dict(runs, first_logits_correlation=c, gather_token_agreement=int(agree))
    out["profile"] = {route: profile_prefill_chunk(cfg, qparams, device, prompts[0], "int8",
                                                   route) for route in ("kernel", "gather")}
    return out


# ---------------------------------------------------------------------------
# phase 11: the kv_sweep pass
# ---------------------------------------------------------------------------

SWEEP_BATCH, SWEEP_SEQ = 4, 2048


def _route_tolerance(q, kd, vd, scale, y_kernel):
    """Bound on |kernel - gather route| of one layer's attention on the same
    q, K/V: the kernel's bound against the reference's ``attention``
    (``_flash_tolerance`` with one more rounding per score), plus what the
    gather route rounds to the bf16 activations: the gathered K (2⁻⁹ of
    each element) and the bf16 logits (2⁻⁹ of each) move a score by at most
    2·2⁻⁹·S, so the weights by a factor within e^(±2·δ), δ = 2·2⁻⁹·S, and
    the output by (e^(2δ) - 1)·v_max; the gathered V and the bf16
    probabilities add 2⁻⁹·v_max each; both outputs round to bf16 (2⁻⁶ of
    the larger side each)."""
    import torch

    d = q.shape[-1]
    tol = _flash_tolerance(q, kd, vd, scale, y_kernel.float()) * (d + 1) / d
    b, sq, h, _ = q.shape
    kh = kd.shape[2]
    g = h // kh
    kmax = kd.double().abs().amax(dim=1)
    qs = (q.double() * scale).abs().reshape(b, sq, kh, g, d)
    s_max = torch.einsum("bskgd,bkd->bskg", qs, kmax).reshape(b, sq, h, 1)
    vmax = vd.double().abs().amax(dim=(1, 3)).repeat_interleave(g, dim=1)[:, None, :, None]
    delta = 2 * 2.0 ** -9 * s_max
    return (tol + torch.expm1(2 * delta) * vmax + 2 * 2.0 ** -9 * vmax
            + 2 * 2.0 ** -6 * y_kernel.double().abs())


def phase_kv_sweep(device):
    """The port's kv_sweep pass (``repro_torch.bench.kv_sweep``): one
    full-sequence ``paged_step`` of SmolLM-135M at full width and depth
    (random bf16 weights from seed 0, float linears as the reference's
    sweep keeps them) over SWEEP_BATCH x SWEEP_SEQ eval tokens, for each
    pool of ``kv_sweep.SWEEP``, on the kernel route (exactly one #7 or #8
    launch per layer, nothing else) and on the gather route.  Gates: layer
    0's kernel call within ``_flash_tolerance`` of its plain version on the
    same operands; layer 0's attention output of the two routes within
    ``_route_tolerance``; finite logits.  Printed: PPL and ACC (on random weights they only show
    that the path runs), the logits' correlation between the routes, and
    bytes per token."""
    import torch

    from repro_torch.bench import kv_sweep
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn, ops
    from repro_torch.kernels.context import KernelContext
    from repro_torch.models import common, model
    from repro_torch.serve.kvquant import dequantize_kv

    cfg = get_config("smollm-135m")
    params = model.init_params(cfg, seed=0, device=device)
    toks = kv_sweep.eval_batches(cfg, n=1, bsz=SWEEP_BATCH, seq=SWEEP_SEQ,
                                 device=device)[0]["tokens"]
    print(f"  {cfg.name}: {cfg.n_layers} layers, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
          f"head_dim {cfg.head_dim}; {SWEEP_BATCH} x {SWEEP_SEQ} eval tokens; PPL and ACC "
          f"of random weights: they show the path runs, not accuracy", flush=True)
    out, counts_all = {}, {}
    for name, spec in kv_sweep.SWEEP:
        kern = "flash_attention_quant" if spec.is_quantized else "flash_attention"
        seen = {}
        orig_k, orig_g = getattr(ops, kern), common.attention

        def capture_kernel(*a, **kw):
            y = orig_k(*a, **kw)
            seen.setdefault("kernel", (a, kw, y))
            return y

        def capture_gather(q, k, v, mask, scale):
            y = orig_g(q, k, v, mask, scale)
            seen.setdefault("gather", y)
            return y

        logits = {}
        reset_launches()
        setattr(ops, kern, capture_kernel)
        try:
            logits["kernel"] = kv_sweep.paged_step_logits(cfg, params, toks, spec)
            torch.cuda.synchronize()
        finally:
            setattr(ops, kern, orig_k)
        counts = launches()
        want = {k: (cfg.n_layers if k == kern else 0) for k in counts}
        if counts != want:
            raise SystemExit(f"kv_sweep {name}: launches {counts}, want {want}")
        counts_all[name] = counts[kern]
        common.attention = capture_gather
        try:
            logits["gather"] = kv_sweep.paged_step_logits(
                cfg, params, toks, spec, KernelContext(attention="gather"))
            torch.cuda.synchronize()
        finally:
            common.attention = orig_g
        a, kw, y_k = seen["kernel"]
        q, d = a[0], a[0].shape[-1]
        if spec.is_quantized:
            kd = dequantize_kv(a[1], a[2], spec, d)
            vd = dequantize_kv(a[3], a[4], spec, d)
        else:
            kd, vd = a[1].float(), a[2].float()
        y_g = seen["gather"]
        scale = a[3 if not spec.is_quantized else 5]
        # the captured layer-0 call (bf16 q over the pool's K/V) against the
        # kernel's plain version on the same operands
        y_p = getattr(flash_attn, kern + "_plain")(*a, **kw)
        q0 = kw["q_start"].double()[:, None, None]
        err_p = (y_k.double() - y_p.double()).abs()
        ok_p = bool((err_p <= _flash_tolerance(q, kd, vd, scale, y_p, q0)).all())
        tol = _route_tolerance(q, kd, vd, scale, y_k)
        err = (y_k.double() - y_g.double()).abs()
        ok = (ok_p and bool((err <= tol).all())
              and all(bool(torch.isfinite(l).all()) for l in logits.values()))
        res = {}
        for route, lg in logits.items():
            res[route] = kv_sweep.ppl_acc([kv_sweep.score(lg, toks)])
        c = torch.corrcoef(torch.stack([logits["kernel"][0].flatten(),
                                        logits["gather"][0].flatten()]))[0, 1].item()
        bpt = cfg.n_layers * spec.kv_bytes_per_token(cfg.n_kv_heads, cfg.head_dim)
        print(f"  {name:<9} kernel route ppl {res['kernel'][0]:.4f} acc {res['kernel'][1]:.5f}"
              f" | gather route ppl {res['gather'][0]:.4f} acc {res['gather'][1]:.5f} | "
              f"logits correlation {c:.6f}; layer-0 attention ({str(q.dtype)[6:]} q, "
              f"{name} K/V) "
              f"max |kernel - plain| {err_p.max().item():.3e} ({'ok' if ok_p else 'FAIL'}), "
              f"max |kernel - gather| {err.max().item():.3e} (bound min "
              f"{tol.min().item():.3e}) "
              f"{'ok' if ok else 'FAIL'}; {counts[kern]} {kern} launches; {bpt} bytes per "
              f"token", flush=True)
        if not ok:
            raise SystemExit(f"kv_sweep {name}: the kernel route's layer-0 attention "
                             f"is outside the bound of its plain version's or of the "
                             f"gather route's, or the logits are not finite")
        out[name] = {"ppl_acc": res, "logits_correlation": c,
                     "layer0_max_abs_diff": err.max().item(),
                     "layer0_kernel_vs_plain": err_p.max().item(), "bytes_per_token": bpt}
        del logits, seen
        torch.cuda.empty_cache()
    return out, counts_all


# ---------------------------------------------------------------------------
# phase 12: the paper's layer-latency tables, rotated and unrotated
# ---------------------------------------------------------------------------


def phase_latency(device):
    """``repro_torch.bench.latency_kernels`` on the card: the smoke rows
    (codes and scales bitwise across the chained and unfused paths), then
    the measured Tables 6-8 rows and Phi-3-mini's mlp/wd site.  Every
    configuration is held once, step by step (``check_path``): codes,
    scales and rotated rows bitwise their plain versions, x·V within its
    K-term bound, the output bitwise the GEMM kernel's on the path's own
    operands and within the R-term bound of the plain GEMM on them (the
    fused path, K <= 1024, within the whole layer's bound).  The measured
    rows are the main path: their kernel launches must be exactly those of
    the calls they made (one fwht per rotated unfused call, none
    otherwise); the checks' own launches are not counted."""
    import torch

    from repro_torch.bench import latency_kernels as lk

    t0 = time.perf_counter()
    smoke = lk.smoke_rows(device)
    torch.cuda.synchronize()
    print(f"  smoke rows ({time.perf_counter() - t0:.1f} s; µs of one call, L2 "
          f"flushed; each path held step by step against its plain version, "
          f"max_err_over_bound the largest |kernel - plain| over its bound):", flush=True)
    lk.print_table(smoke, out=lambda line: print("    " + line, flush=True))
    t1 = time.perf_counter()
    calls = lk.Calls()
    reset_launches()
    print(f"  measured rows (bf16 x and factors; median of {lk.REPS} timed calls, "
          f"{lk.REPS_PREFILL} at M = {max(lk.MS)}, L2 flushed before each):", flush=True)
    print("    " + ",".join(lk.HEADER), flush=True)
    measured = lk.measured_rows(device, calls, log=lambda row: lk.print_table(
        [row], header=None, out=lambda line: print("    " + line, flush=True)))
    torch.cuda.synchronize()
    counts = {k: c for k, c in launches().items() if not k.endswith("_plain")}
    want = {k: 0 for k in counts}
    want.update(calls.expected_launches())
    print(f"  {sum(calls.n.values())} forward calls {dict((f'{p}/rot={r}', c) for (p, r), c in calls.n.items())}; "
          f"launches {counts} (want {want}); {time.perf_counter() - t1:.1f} s", flush=True)
    if counts != want:
        raise SystemExit("latency: the measured calls' kernel launches are not one "
                         "fwht per rotated unfused call and the path's kernels")
    alone = _gemm_alone(device)
    return {"smoke": smoke, "measured": measured, "launches": counts,
            "gemm_alone": alone, "seconds": time.perf_counter() - t0}


# phase 12's GEMM kernel timed alone: M and ranks
ALONE_MS = (256, 2048)
ALONE_RANKS = (0, 128)


def _gemm_alone(device):
    """The GEMM kernel (#2) alone at phase 12's sizes and Phi-3-mini's wd,
    M = ALONE_MS, ranks ALONE_RANKS (bf16 x and U, codes from the prologue
    kernel), beside its bounds (the int8 operations, the LR term's f32
    ones, the bytes) and, as context only, ``torch._int_mm`` on the
    pre-unpacked int8 codes (the integer product alone: no unpacking, no
    rescale, no LR term) and a bf16 ``torch.matmul``.  µs, median of
    latency_kernels' REPS (REPS_PREFILL at M 2048), L2 flushed."""
    import torch

    from repro_torch.bench import latency_kernels as lk
    from repro_torch.bench.common import flush_buffer, time_ms, w4a4_problem
    from repro_torch.kernels import prologue, w4a4
    from repro_torch.kernels.rowops import unpack_int4_rows

    bf16 = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(12)
    flush = flush_buffer(device)
    rows = []
    print("  the GEMM kernel alone (µs; bounds: int8 ops over 1,979 TOPS, the LR "
          "term's f32 ops over 67 TFLOP/s, bytes over 3.35 TB/s; _int_mm and the bf16 "
          "matmul are context only):", flush=True)
    for k, n in list(lk.SIZES) + [lk.PHI3_WD]:
        rmax = max(ALONE_RANKS)
        x_all, v, wp, sw, u = w4a4_problem(gen, max(ALONE_MS), k, n, rmax, bf16, bf16, device)
        w8 = unpack_int4_rows(wp).contiguous()
        w_bf16 = torch.randn((k, n), generator=gen, device=device).to(bf16)
        for m in ALONE_MS:
            reps = lk.REPS_PREFILL if m >= 2048 else lk.REPS
            xq, sx, xv = prologue.fused_prologue(x_all[:m], v, 4, 0.9)
            t_mm = time_ms(lambda: torch.matmul(x_all[:m], w_bf16), flush, reps, lk.WARMUP)
            try:
                t_int = time_ms(lambda: torch._int_mm(xq, w8), flush, reps, lk.WARMUP)
                why = ""
            except RuntimeError as e:
                t_int, why = None, str(e).splitlines()[0]
            for r in ALONE_RANKS:
                ur, xr = (u[:, :r].contiguous(), xv[:, :r].contiguous()) if r else (None, None)
                t = time_ms(lambda: w4a4.w4a4_lowrank_matmul(xq, sx, wp, sw, xr, ur), flush,
                            reps, lk.WARMUP)
                int8_ms = 2 * m * k * n / INT8_OPS_PER_S * 1e3
                f32_ms = (2 * m * n * r + 2 * m * n) / F32_OPS_PER_S * 1e3
                bytes_ms = (m * k + 4 * m + k * n // 2 + 4 * n + 4 * m * r + 2 * n * r
                            + 4 * m * n) / HBM_BYTES_PER_S * 1e3
                row = {"k": k, "n": n, "m": m, "r": r, "us": t * 1e3,
                       "int8_bound_us": int8_ms * 1e3, "f32_bound_us": f32_ms * 1e3,
                       "bytes_bound_us": bytes_ms * 1e3,
                       "int_mm_us": None if t_int is None else t_int * 1e3,
                       "bf16_matmul_us": t_mm * 1e3}
                rows.append(row)
                int_mm = (f"{t_int * 1e3:.1f}" if t_int is not None
                          else f"refused ({why})")
                print(f"    N×K {n}x{k} M={m:<4} R={r:<3} #2 {t * 1e3:9.1f}  int8 bound "
                      f"{int8_ms * 1e3:7.1f}  f32 bound {f32_ms * 1e3:7.1f}  bytes bound "
                      f"{bytes_ms * 1e3:6.1f}  ({t / max(int8_ms, f32_ms, bytes_ms):.2f}x "
                      f"the bound)  _int_mm {int_mm}  bf16 matmul {t_mm * 1e3:.1f}",
                      flush=True)
            del xq, sx, xv
        del x_all, v, wp, sw, u, w8, w_bf16
        torch.cuda.empty_cache()
    return rows


def add_rotation_entries(kernels, rot_worst, rot_timed, lat):
    """The online rotation's part of the ``kernels`` line: phase 12's
    launches and the rotate branches' phase-3 times on the fused kernel's
    and the prologue's entries (``kernels[0]``, ``kernels[1]``), and the
    transform kernel's (#5) own entry, appended."""
    rot_keys = ("ms", "unrotated_ms", "plain_ms", "bound_ms", "bound_by")
    kernels[0]["launches"] += lat["fused_w4a4_lrc"]
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], rot_worst["fused_w4a4_lrc"])
    kernels[0]["rotate"] = {"M{}_K{}_N{}_R{}".format(*key[1:]): dict(zip(rot_keys, v))
                            for key, v in rot_timed.items() if key[0] == "fused_w4a4_lrc"}
    kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], rot_worst["fused_prologue"])
    kernels[1]["rotate"] = {"M{}_K{}_R{}".format(*key[1:]): dict(zip(rot_keys, v))
                            for key, v in rot_timed.items() if key[0] == "fused_prologue"}
    fwht_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    t_k, t_p, b_ms, by, t_l = rot_timed[("fwht", 2048, 8192, "bfloat16")]
    kernels.append({
        "name": "fwht", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fwht.cu",
        "replaces": "src/repro/kernels/hadamard.py:27",
        "launches": lat["fwht"], "max_abs_err": rot_worst["fwht"],
        "ms": t_k, "plain_ms": t_p, "bound_ms": b_ms, "bound_by": by,
        "library_ms": t_l, "checked": True,
        "at": ("M 2048, D 8192, bf16 (phase 12's prefill rows at K 8192), L2 flushed; "
               "library: torch.matmul(x.float(), H_D) with TF32 off; launches from "
               "phase 12's measured rows (one per rotated unfused call)"),
        "shapes": {"M{}_D{}_{}".format(*key[1:]): dict(zip(fwht_keys, v))
                   for key, v in rot_timed.items() if key[0] == "fwht"},
    })


# ---------------------------------------------------------------------------
# phase 13: grouped activation scales
# ---------------------------------------------------------------------------

# SmolLM-135M's K = 576 takes no 128, so it is served at the reference
# harness's group 64; Phi-3-mini at the paper's Table 2 group 128
SMOL_GROUP = 64
PHI3_GROUP = 128
GROUP_MS = (SLOTS, 100, 2048)
# kernel #1: SmolLM's site shapes at g 64, then a rotated K 512 at g 128
# and ragged ones (odd N, K % 16 != 0): groups of 10 and of 45 (K % 4 == 2)
# end inside a four-code word (K, N, R, rotate, g)
GROUP_FUSED_CASES = ([(k, n, r, False, SMOL_GROUP) for (k, n, r) in sorted(set(SITES.values()))]
                     + [(512, 1536, 58, True, 128), (200, 97, 7, False, 10),
                        (90, 33, 0, False, 45)])
# kernels #2-#4: Phi-3's site shapes at g 128, its rotated wd at R 922, then
# ragged ones: K 192 in three groups, g = K with odd N, K 200 at g = K
# (K % 16 != 0), groups of 8, of 10 and of 45 (K % 4 == 2; the last two
# end inside a four-code word) (K, N, R, rotate, g)
GROUP_CHAIN_CASES = ([(k, n, r, False, PHI3_GROUP)
                      for (k, n, r) in sorted(set(PHI3_SITES.values()))]
                     + [(8192, 3072, 922, True, PHI3_GROUP), (192, 97, 7, False, 64),
                        (3072, 3073, 307, False, 3072), (200, 33, 5, False, 200),
                        (200, 33, 5, False, 8), (200, 33, 5, False, 10),
                        (90, 33, 0, False, 45)])
# Phi-3 prompts of phase 10 whose grouped streams must not depend on the
# prefill chunk width
GROUP_LONG_PROMPTS = (777, 130)


def _group_bounds(m, k, n, r, g, x_bytes, f_bytes):
    """Bounds of the four kernels' group branches at one site (each input
    read once, each output written once): as per-token, with the (M, K/g)
    f32 scale plane in place of the (M, 1) scales."""
    plane = 4 * m * (k // g)
    prologue = _bound(x_bytes * m * k + f_bytes * k * r + m * k + plane + 4 * m * r,
                      f32_ops=2 * m * k * r + 3 * m * k)
    quant = _bound(x_bytes * m * k + m * k + plane, f32_ops=3 * m * k)
    gemm = _bound(m * k + plane + k * n // 2 + 4 * n + 4 * m * r + f_bytes * n * r
                  + 4 * m * n, int8_ops=2 * m * k * n,
                  f32_ops=2 * m * n * r + 2 * m * n * (k // g) + m * n)
    fused = _bound(k * n // 2 + 4 * n + f_bytes * r * (k + n) + x_bytes * m * k + 4 * m * n,
                   int8_ops=2 * m * k * n,
                   f32_ops=2 * m * r * (k + n) + 2 * m * n * (k // g) + 3 * m * k)
    return {"fused_w4a4_lrc": fused, "fused_prologue": prologue, "act_quant": quant,
            "w4a4_lowrank_matmul": gemm}


def _same(a, b, what):
    import torch

    if not torch.equal(a, b):
        raise SystemExit(f"grouped kernels: {what} is not bitwise its reference")


def phase_group_kernels(device):
    """13(a): each kernel's group branch against its plain version at the
    shapes the grouped paths give it, M = SLOTS, 100 and 2048 (the smaller
    M the first rows of the 2048-row problem), bf16 x and factors at the
    sites, f32 at the ragged shapes:

      * #1 (SmolLM's sites at g 64, a rotated K 512 at g 128): without V
        bitwise the plain version, with V within the LR sums' bound;
      * #4 and #3 (Phi-3's sites at g 128, its rotated wd at R 922, ragged
        groups): codes and scale planes bitwise the plain versions' (and
        each other's, unrotated), #3's x·V within its bound, with V and
        without;
      * #2 on the plain prologue's operands: without the LR term bitwise the
        plain ``gemm_grouped`` order, with it within the R-term bound;
      * every kernel's rows at M = SLOTS and 100 bitwise the same rows of
        the M = 2048 call (#2 without the LR term, whose plain x·V operand
        is a cuBLAS product; #2 splits K at Phi-3's wd, M = SLOTS, and not
        at 2048: the split does not enter);
      * g = K bitwise the per-token kernel.

    At M = SLOTS each site's grouped and per-token kernels and the grouped
    plain version are timed (CUDA events, L2 flushed) beside the grouped
    bound.  Returns (worst error per kernel, times)."""
    import torch

    from repro_torch.bench.common import (flush_buffer, gemm_tolerance, lr_tolerance,
                                          time_ms, w4a4_problem, xv_tolerance)
    from repro_torch.kernels import actquant, fused_gemm, hadamard, prologue, w4a4

    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=device).manual_seed(13)
    flush = flush_buffer(device)
    worst = {"fused_w4a4_lrc": 0.0, "fused_prologue": 0.0, "w4a4_lowrank_matmul": 0.0,
             "act_quant": 0.0}
    timed = {}
    smol_shapes = set(SITES.values())
    phi3_shapes = set(PHI3_SITES.values())

    def rows_of(out, whole, m, what):
        """The first m rows of the 2048-row call's ``whole`` output."""
        for a, b in zip(out, whole):
            if a is not None:
                _same(a, b[:m], f"{what}: rows of M={m} against M={max(GROUP_MS)}")

    for (k, n, r, rot, g) in GROUP_FUSED_CASES:
        xd = bf16 if (k, n, r) in smol_shapes else f32
        x_all, v, wp, sw, u = w4a4_problem(gen, max(GROUP_MS), k, n, r, xd, xd, device, g)
        whole = {}
        for m in sorted(GROUP_MS, reverse=True):
            x = x_all[:m]
            y = fused_gemm.fused_w4a4_lrc(x, v, wp, sw, u, 4, 0.9, rot, g)
            y0 = fused_gemm.fused_w4a4_lrc(x, None, wp, sw, None, 4, 0.9, rot, g)
            torch.cuda.synchronize()
            y_p = fused_gemm.fused_w4a4_lrc_plain(x, v, wp, sw, u, 4, 0.9, rot, g)
            y0_p = fused_gemm.fused_w4a4_lrc_plain(x, None, wp, sw, None, 4, 0.9, rot, g)
            _same(y0, y0_p, f"#1 without V at M={m} K={k} N={n} g={g} rotate={rot}")
            _fused_gate(y, x, v, wp, sw, u, rot, g, f"grouped M={m} K={k} N={n} g={g}")
            _fused_gate(y0, x, None, wp, sw, None, rot, g, f"grouped M={m} K={k} N={n} g={g} "
                        f"without V")
            rows = hadamard.fwht_plain(x.float()) if rot else x
            err = (y - y_p).abs()
            if not (bool(torch.isfinite(y).all())
                    and bool((err <= lr_tolerance(rows, v, u, k, r, y_p)).all())):
                raise SystemExit(f"grouped kernels: #1 disagrees with its plain version "
                                 f"at M={m} K={k} N={n} R={r} g={g}")
            worst["fused_w4a4_lrc"] = max(worst["fused_w4a4_lrc"], err.max().item())
            if m == max(GROUP_MS):
                whole = (y, y0)
            else:
                rows_of((y, y0), whole, m, f"#1 K={k} N={n} g={g}")
            if m == 100:
                _same(fused_gemm.fused_w4a4_lrc(x, v, wp, sw, u, 4, 0.9, rot, k),
                      fused_gemm.fused_w4a4_lrc(x, v, wp, sw, u, 4, 0.9, rot),
                      f"#1 at g = K={k} against per-token")
            if m == SLOTS and (k, n, r) in smol_shapes:
                t_g = time_ms(lambda: fused_gemm.fused_w4a4_lrc(x, v, wp, sw, u, 4, 0.9,
                                                                rot, g), flush)
                t_t = time_ms(lambda: fused_gemm.fused_w4a4_lrc(x, v, wp, sw, u, 4, 0.9,
                                                                rot), flush)
                t_p = time_ms(lambda: fused_gemm.fused_w4a4_lrc_plain(x, v, wp, sw, u, 4,
                                                                      0.9, rot, g), flush)
                b, by = _group_bounds(m, k, n, r, g, 2, 2)["fused_w4a4_lrc"]
                timed[("fused_w4a4_lrc", k, n, r)] = (t_g, t_t, t_p, b, by)
        print(f"  #1 K={k:<5} N={n:<5} R={r:<3} g={g:<4} rotate={rot!s:<5} x={str(xd)[6:]:<8} "
              f"M {GROUP_MS}: without V bitwise, bitwise the chained path, rows independent "
              f"of M, g = K bitwise per-token; max |kernel - plain| "
              f"{worst['fused_w4a4_lrc']:.3e}", flush=True)

    for (k, n, r, rot, g) in GROUP_CHAIN_CASES:
        xd = bf16 if (k, n, r) in phi3_shapes else f32
        x_all, v, wp, sw, u = w4a4_problem(gen, max(GROUP_MS), k, n, r, xd, xd, device, g)
        whole, worst_case = {}, {"xv": 0.0, "gemm": 0.0}
        for m in sorted(GROUP_MS, reverse=True):
            x = x_all[:m]
            xq, sx, xv = prologue.fused_prologue(x, v, 4, 0.9, rot, g)
            q0, s0, _ = prologue.fused_prologue(x, None, 4, 0.9, rot, g)
            xr = hadamard.fwht(x) if rot else x
            aq, asx = actquant.act_quant(xr, 4, 0.9, g)
            torch.cuda.synchronize()
            xq_p, sx_p, xv_p = prologue.fused_prologue_plain(x, v, 4, 0.9, rot, g)
            aq_p, asx_p = actquant.act_quant_plain(xr, 4, 0.9, g)
            what = f"M={m} K={k} N={n} R={r} g={g} rotate={rot}"
            for a, b, name in ((xq, xq_p, "#3 codes"), (sx, sx_p, "#3 scale plane"),
                               (q0, xq_p, "#3 codes without V"),
                               (s0, sx_p, "#3 scale plane without V"),
                               (aq, aq_p, "#4 codes"), (asx, asx_p, "#4 scale plane")):
                _same(a, b, f"{name} at {what}")
            if not rot or xd is f32:  # a bf16 rotated row rounds before #4
                _same(aq, xq_p, f"#4 codes against #3's at {what}")
                _same(asx, sx_p, f"#4 scale plane against #3's at {what}")
            if r:
                err = (xv - xv_p).abs()
                rows = hadamard.fwht_plain(x.float()) if rot else x
                if not bool((err <= xv_tolerance(rows, v, k, xv_p)).all()):
                    raise SystemExit(f"grouped kernels: #3's x·V outside its bound at {what}")
                worst_case["xv"] = max(worst_case["xv"], err.max().item())
            y0 = w4a4.w4a4_lowrank_matmul(xq_p, sx_p, wp, sw, None, None, g)
            y = w4a4.w4a4_lowrank_matmul(xq_p, sx_p, wp, sw, xv_p, u, g)
            torch.cuda.synchronize()
            _same(y0, w4a4.w4a4_lowrank_matmul_plain(xq_p, sx_p, wp, sw, None, None, g),
                  f"#2 without the LR term at {what}")
            y_p = w4a4.w4a4_lowrank_matmul_plain(xq_p, sx_p, wp, sw, xv_p, u, g)
            err = (y - y_p).abs()
            if not (bool(torch.isfinite(y).all())
                    and bool((err <= gemm_tolerance(xv_p, u, r, y_p)).all())):
                raise SystemExit(f"grouped kernels: #2 disagrees with its plain version "
                                 f"at {what}")
            worst_case["gemm"] = max(worst_case["gemm"], err.max().item())
            # x·V of the plain version is a cuBLAS product whose order may
            # change with M, so the GEMM's rows are compared without it
            out = (xq, sx, xv, q0, s0, aq, asx, y0)
            if m == max(GROUP_MS):
                whole = out
            else:
                rows_of(out, whole, m, f"K={k} N={n} g={g} rotate={rot}")
            if m == 100 and not rot:
                qk, sk = actquant.act_quant(x, 4, 0.9, k)
                qt, st = actquant.act_quant(x, 4, 0.9)
                _same(qk, qt, f"#4 codes at g = K={k} against per-token")
                _same(sk, st, f"#4 scales at g = K={k} against per-token")
                pk = prologue.fused_prologue(x, v, 4, 0.9, False, k)
                pt = prologue.fused_prologue(x, v, 4, 0.9)
                for a, b in zip(pk, pt):
                    if a is not None:
                        _same(a, b, f"#3 at g = K={k} against per-token")
                _same(w4a4.w4a4_lowrank_matmul(qt, st, wp, sw, xv_p, u, k),
                      w4a4.w4a4_lowrank_matmul(qt, st, wp, sw, xv_p, u),
                      f"#2 at g = K={k} against per-token")
            if m == SLOTS and (k, n, r) in phi3_shapes and not rot:
                bounds = _group_bounds(m, k, n, r, g, 2, 2)
                runs = {
                    "fused_prologue": (
                        lambda: prologue.fused_prologue(x, v, 4, 0.9, False, g),
                        lambda: prologue.fused_prologue(x, v, 4, 0.9),
                        lambda: prologue.fused_prologue_plain(x, v, 4, 0.9, False, g)),
                    "act_quant": (lambda: actquant.act_quant(x, 4, 0.9, g),
                                  lambda: actquant.act_quant(x, 4, 0.9),
                                  lambda: actquant.act_quant_plain(x, 4, 0.9, g)),
                    "w4a4_lowrank_matmul": (
                        lambda: w4a4.w4a4_lowrank_matmul(xq_p, sx_p, wp, sw, xv_p, u, g),
                        lambda: w4a4.w4a4_lowrank_matmul(xq_p, sx_p[:, :1].contiguous(),
                                                         wp, sw, xv_p, u),
                        lambda: w4a4.w4a4_lowrank_matmul_plain(xq_p, sx_p, wp, sw, xv_p,
                                                               u, g)),
                }
                for name, (kern, per_token, plain) in runs.items():
                    timed[(name, k, n, r)] = (time_ms(kern, flush), time_ms(per_token, flush),
                                              time_ms(plain, flush), *bounds[name])
        worst["fused_prologue"] = max(worst["fused_prologue"], worst_case["xv"])
        worst["w4a4_lowrank_matmul"] = max(worst["w4a4_lowrank_matmul"], worst_case["gemm"])
        print(f"  #2-#4 K={k:<5} N={n:<5} R={r:<4} g={g:<5} rotate={rot!s:<5} "
              f"x={str(xd)[6:]:<8} M {GROUP_MS}: codes and scale planes bitwise, #2 "
              f"without LR bitwise, rows independent of M; max |kernel - plain| x·V "
              f"{worst_case['xv']:.3e}, GEMM {worst_case['gemm']:.3e}", flush=True)
    for key, (t_g, t_t, t_p, b, by) in sorted(timed.items()):
        print(f"    {key[0]:<20} K={key[1]:<5} N={key[2]:<5} R={key[3]:<3} M={SLOTS}: "
              f"grouped {t_g * 1e3:8.2f} us, per-token {t_t * 1e3:8.2f} us, plain grouped "
              f"{t_p * 1e3:9.2f} us, grouped bound {b * 1e3:.3f} us ({by})", flush=True)
    return worst, timed


def phase_groups(device, cfg, qparams, pcfg, pparams):
    """Phase 13: (a) :func:`phase_group_kernels`; (b) SmolLM-135M served at
    g = SMOL_GROUP (the fused path) and Phi-3-mini at g = PHI3_GROUP (the
    chained path), phases 4 and 6's RTN+SVD weights retagged with the
    policy's groups (``retag_act_group``: bitwise what ``quantize_model``
    gives under that policy, which reads no statistics here), with the
    launch gates of :func:`phase_serve`; (c) Phi-3's teacher-forced step
    on the chained and unfused paths (:func:`phase_paths`) at g =
    PHI3_GROUP, and two of phase 10's prompts served whole and in 100-row
    chunks, whose greedy streams must be bitwise equal; (d) one full-width
    Phi-3-mini layer calibrated with act_group = PHI3_GROUP (Update-LR
    never raises a loss).  Returns the phase's stats."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.loader import calib_sequences
    from repro_torch.models import model
    from repro_torch.quant.policy import QuantPolicy
    from repro_torch.quant.qlinear import retag_act_group

    t0 = time.perf_counter()
    print("  (a) each kernel's group branch against its plain version", flush=True)
    worst, timed = phase_group_kernels(device)
    out = {"kernels_s": time.perf_counter() - t0}

    print(f"  (b) SmolLM-135M at act_group {SMOL_GROUP} (fused path)", flush=True)
    sq = retag_act_group(qparams, QuantPolicy(act_group=SMOL_GROUP))
    smol_counts, out["smollm_serve"] = phase_serve(cfg, sq, device, ["fused_w4a4_lrc"])
    print(f"  (b) Phi-3-mini at act_group {PHI3_GROUP} (chained path)", flush=True)
    pq = retag_act_group(pparams, QuantPolicy(act_group=PHI3_GROUP))
    phi3_counts, out["phi3_serve"] = phase_serve(
        pcfg, pq, device, ["fused_prologue", "w4a4_lowrank_matmul"])

    print(f"  (c) Phi-3-mini teacher-forced paged_step at act_group {PHI3_GROUP}",
          flush=True)
    out["phi3_paths"] = phase_paths(pcfg, pq, device)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, pcfg.vocab_size, n).astype(np.int32) for n in LONG_PROMPTS]
    prompts = [p for p in prompts if len(p) in GROUP_LONG_PROMPTS]
    streams = {}
    for chunk in LONG_CHUNKS:
        streams[chunk], out[f"long/{chunk}"], _ = _serve_long(
            pcfg, pq, device, prompts, "f32", chunk, "kernel")
    same = streams[None] == streams[LONG_CHUNKS[1]]
    print(f"  (c) prompts {GROUP_LONG_PROMPTS} at act_group {PHI3_GROUP}: greedy streams "
          f"chunk None vs {LONG_CHUNKS[1]} {'bitwise equal' if same else 'DIFFER'}",
          flush=True)
    if not same:
        raise SystemExit("grouped serving: the streams depend on the prefill chunk width")
    del sq, pq
    torch.cuda.empty_cache()

    print(f"  (d) one Phi-3-mini layer calibrated with act_group {PHI3_GROUP}", flush=True)
    policy = QuantPolicy(**CALIB_POLICY, act_group=PHI3_GROUP)
    lcfg = dataclasses.replace(get_config("phi3-mini-3.8b"), n_layers=1)
    lparams = model.init_params(lcfg, seed=0, device=device)
    tokens = calib_sequences(lcfg, n_seq=PHI3_CALIB_SEQS, seq_len=CALIB_SEQ_LEN,
                             device=device)
    stage = StageTimes()
    reset_launches()
    calibrated = stage.run(lcfg, lparams, tokens, policy)
    tags = {q.act_group for q in calibrated["layers"][0]["attn"].values()}
    tags |= {q.act_group for q in calibrated["layers"][0]["mlp"].values()}
    if launches()["flash_attention"] != 1 or len(stage.lrc) != 7 or tags != {PHI3_GROUP}:
        raise SystemExit("grouped calibration: the layer's attention did not go through "
                         "the kernel, not every site was solved, or a site is not tagged "
                         f"with act_group {PHI3_GROUP} ({tags})")
    _check_update_lr(stage)
    out["calibration"] = stage.summary()
    _print_times(f"{lcfg.name} (1 layer, act_group {PHI3_GROUP})", out["calibration"])
    print(f"  Update-LR lowered or kept the loss at all {len(stage.lrc)} sites", flush=True)
    del stage, lparams, tokens, calibrated
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out, worst, timed, smol_counts, phi3_counts


def add_group_entries(kernels, worst, timed, smol_counts, phi3_counts, paths):
    """The ``grouped`` sub-entry of kernels #1-#4 (``kernels[0:4]``): one
    layer's sites at M = SLOTS (SmolLM's 7 at g 64 for #1, Phi-3's 7 at g
    128 for the others), the per-token kernel's time at the same sites
    beside it, the launches of phase 13's main paths (serving for #1-#3,
    the teacher-forced unfused step for #4), which the kernel's own
    ``launches`` then include, and the largest |kernel - plain|."""
    launched = {"fused_w4a4_lrc": smol_counts["fused_w4a4_lrc"],
                "fused_prologue": phi3_counts["fused_prologue"],
                "w4a4_lowrank_matmul": phi3_counts["w4a4_lowrank_matmul"],
                "act_quant": paths["act_quant_launches"]}
    for entry in kernels[:4]:
        name = entry["name"]
        sites = SITES if name == "fused_w4a4_lrc" else PHI3_SITES
        layer = [timed[(name, *sites[s])] for s in sites]
        entry["grouped"] = {
            "group": SMOL_GROUP if name == "fused_w4a4_lrc" else PHI3_GROUP,
            "ms": sum(t[0] for t in layer), "per_token_ms": sum(t[1] for t in layer),
            "plain_ms": sum(t[2] for t in layer), "bound_ms": sum(t[3] for t in layer),
            "bound_by": ("bytes" if all(t[4] == "bytes" for t in layer)
                         else "operations"),
            "launches": launched[name], "max_abs_err": worst[name],
            "at": (f"one layer's 7 sites at M={SLOTS}, bf16, L2 flushed; launches from "
                   f"phase 13's serving (#1 SmolLM, #2/#3 Phi-3) and teacher-forced "
                   f"unfused step (#4)"),
        }
        entry["launches"] += launched[name]
        entry["max_abs_err"] = max(entry["max_abs_err"], worst[name])


# ---------------------------------------------------------------------------
# phase 14: Gemma-7b, head_dim 256
# ---------------------------------------------------------------------------

# kernels #7 and #8 at head dims up to 128, each (B, Sq, Skv, H, KH, D, Dv,
# q_start, q dtype, K/V dtype or quantized pool): ragged S, GQA and MQA, a
# chunk with a query offset, D != Dv, bf16 q over f32 K/V, int8 and int4
# codes, and head dims that are not multiples of 8 (zero-padded features;
# rows, or groups of codes, too narrow for whole-chunk loads, staged
# element by element)
SMALL_D_CASES = (
    (2, 300, 300, 8, 2, 64, 64, 0, "float32", "float32"),
    (1, 100, 400, 6, 6, 96, 96, 300, "bfloat16", "float32"),
    (2, 200, 200, 4, 1, 128, 128, 0, "bfloat16", "bfloat16"),
    (1, 256, 256, 8, 4, 128, 96, 0, "float32", "float32"),
    (2, 300, 300, 8, 2, 64, 64, 0, "float32", "int8"),
    (1, 100, 400, 8, 8, 128, 128, 300, "bfloat16", "int4-g32"),
    (2, 150, 150, 4, 2, 98, 60, 0, "float32", "float32"),
    (1, 70, 200, 4, 4, 100, 100, 130, "bfloat16", "bfloat16"),
    (1, 90, 150, 4, 2, 98, 98, 40, "float32", "int8"),
    (1, 70, 150, 4, 4, 100, 100, 60, "bfloat16", "int4"),
)
# kernels #7 and #8 at D 256 (and #7 at D 192 / Dv 128), each (B, Sq, Skv,
# H, KH, D, Dv, q_start, q dtype): Gemma-7b's heads over a whole 2048-token
# prompt with an f32 and a bf16 q, a 100-row chunk of that prompt at 1900
# (its rows must be bitwise the whole prompt's), what serving launches (the
# served model's bf16 q over an f32 pool: a 12-row prompt and the 16-row
# second chunk of a 32-row one over one slot's gathered MPB·P = 64 rows, and
# phase 14(c)'s 777-token prompt whole and its last 77-row chunk at 700, a
# partial query and key tile each), MQA at D 256, and the q·k / v widths
# 192 / 128 (MLA's); #8 takes D = Dv only
GEMMA_FLASH = {
    "gemma": (1, 2048, 2048, 16, 16, 256, 256, 0, "float32"),
    "gemma-bf16": (1, 2048, 2048, 16, 16, 256, 256, 0, "bfloat16"),
    "gemma-chunk": (1, 100, 2048, 16, 16, 256, 256, 1900, "float32"),
    "gemma-chunk-bf16": (1, 100, 2048, 16, 16, 256, 256, 1900, "bfloat16"),
    "gemma-serve12": (1, 12, 64, 16, 16, 256, 256, 0, "bfloat16"),
    "gemma-serve": (1, 32, 64, 16, 16, 256, 256, 0, "bfloat16"),
    "gemma-serve-chunk": (1, 16, 64, 16, 16, 256, 256, 16, "bfloat16"),
    "gemma-777": (1, 777, 777, 16, 16, 256, 256, 0, "bfloat16"),
    "gemma-777-chunk": (1, 77, 777, 16, 16, 256, 256, 700, "bfloat16"),
    "mqa": (4, 512, 512, 8, 1, 256, 256, 0, "float32"),
    "d192-dv128": (2, 512, 512, 16, 4, 192, 128, 0, "float32"),
}


def phase_gemma_kernels(device):
    """Phase 14(a).  Kernels #7 and #8 against their plain versions within
    ``_flash_tolerance`` at every case of SMALL_D_CASES and at every shape of
    PREFILL_SHAPES (#7 over f32 K/V, #8 over each pool of QUANT_POOLS, #8
    bitwise #7 on the dequantized codes); then at every shape of
    GEMMA_FLASH kernel #7 (and #8 on each pool of QUANT_POOLS where D = Dv)
    within ``_flash_tolerance`` of its plain version, #8 bitwise #7 on the
    dequantized codes, a chunk's rows (and the prompt's last row alone)
    bitwise the whole prompt's, all fatal; GEMMA_FLASH timed (median of 30,
    L2 flushed) beside the bound, the plain version and SDPA on an
    expanded-KV copy (for #8 as context only).  Returns (worst error per
    kernel, times per (kernel, label, pool))."""
    import torch

    from repro_torch.bench.common import flush_buffer, time_ms
    from repro_torch.kernels import flash_attn
    from repro_torch.serve.kvquant import dequantize_kv, quantize_kv

    flush = flush_buffer(device)
    gen = torch.Generator(device=device).manual_seed(14)
    worst = {"flash_attention": 0.0, "flash_attention_quant": 0.0}

    def randn(*shape, dtype="float32"):
        return torch.randn(shape, generator=gen, device=device).to(getattr(torch, dtype))

    def small_d(label, q, k, v, qs, q0, kvd):
        """#7 over k, v in ``kvd`` (or #8 over their codes, and #7 on the
        dequantized codes) against the plain version."""
        scale = q.shape[-1] ** -0.5
        if kvd.startswith("int"):
            spec = _kv_spec(kvd)
            (kq, ks), (vq, vs) = quantize_kv(k, spec), quantize_kv(v, spec)
            kd, vd = (dequantize_kv(kq, ks, spec, q.shape[-1]),
                      dequantize_kv(vq, vs, spec, q.shape[-1]))
            args = (q, kq, ks, vq, vs, scale, spec)
            y = flash_attn.flash_attention_quant(*args, q_start=qs)
            y7 = flash_attn.flash_attention(q, kd, vd, scale, q_start=qs)
            torch.cuda.synchronize()
            y_plain = flash_attn.flash_attention_quant_plain(*args, q_start=qs)
            _prefill_gate(worst, "flash_attention_quant", label, kvd, y, y_plain,
                          _flash_tolerance(q, kd, vd, scale, y_plain, q0),
                          torch.equal(y, y7), None)
            return
        k, v = k.to(getattr(torch, kvd)), v.to(getattr(torch, kvd))
        y = flash_attn.flash_attention(q, k, v, scale, q_start=qs)
        torch.cuda.synchronize()
        y_plain = flash_attn.flash_attention_plain(q, k, v, scale, q_start=qs)
        _prefill_gate(worst, "flash_attention", label, kvd, y, y_plain,
                      _flash_tolerance(q, k, v, scale, y_plain, q0), True, None)

    for b, sq, skv, h, kh, d, dv, q0, qd, kvd in SMALL_D_CASES:
        q = randn(b, sq, h, d, dtype=qd)
        k, v = randn(b, skv, kh, d), randn(b, skv, kh, dv) * 1.5
        qs = torch.full((b,), q0, dtype=torch.int32, device=device) if q0 else None
        small_d(f"D{d}/{dv}-S{sq}/{skv}", q, k, v, qs, q0, kvd)
    for label, (b, sq, skv, h, kh, d, q0, qd) in PREFILL_SHAPES.items():
        q = randn(b, sq, h, d, dtype=qd)
        k, v = randn(b, skv, kh, d), randn(b, skv, kh, d) * 1.5
        qs = torch.full((b,), q0, dtype=torch.int32, device=device) if q0 else None
        for kvd in ("float32",) + QUANT_POOLS:
            small_d(label, q, k, v, qs, q0, kvd)
        del q, k, v

    timed, whole = {}, {}

    def chunk_rows(y, full, q0, sq, last):
        """A chunk's rows, and the prompt's last row alone, against the
        whole prompt's (None where the call is not a chunk)."""
        if not q0:
            return None
        return (torch.equal(y, full[:, q0:q0 + sq])
                and torch.equal(last, full[:, q0 + sq - 1:q0 + sq]))

    problems = {}
    for label, shape in GEMMA_FLASH.items():
        b, sq, skv, h, kh, d, dv, q0, qd = shape
        parent = label.replace("-chunk", "")
        if q0:  # rows q0… of the whole prompt of `parent`
            q_all, k, v = problems[parent]
            q = q_all[:, q0:q0 + sq].contiguous()
        else:
            q, k, v = randn(b, sq, h, d, dtype=qd), randn(b, skv, kh, d), randn(b, skv, kh, dv)
            problems[label] = (q, k, v)
        qs = torch.full((b,), q0, dtype=torch.int32, device=device) if q0 else None
        one_qs = None if qs is None else qs + sq - 1
        scale = d ** -0.5

        y = flash_attn.flash_attention(q, k, v, scale, q_start=qs)
        last = None if qs is None else flash_attn.flash_attention(
            q[:, -1:].contiguous(), k, v, scale, q_start=one_qs)
        torch.cuda.synchronize()
        y_plain = flash_attn.flash_attention_plain(q, k, v, scale, q_start=qs)
        if not q0:
            whole[(label, "f32")] = y
        rows = chunk_rows(y, whole.get((parent, "f32")), q0, sq, last)
        _prefill_gate(worst, "flash_attention", label, "f32", y, y_plain,
                      _flash_tolerance(q, k, v, scale, y_plain, q0), True, rows)
        t_k = time_ms(lambda: flash_attn.flash_attention(q, k, v, scale, q_start=qs), flush)
        t_p = time_ms(lambda: flash_attn.flash_attention_plain(q, k, v, scale, q_start=qs),
                       flush)
        t_l = _sdpa_timer(q, k, v, q0, scale, flush)
        b_ms, by, b_cc = _prefill_bound(shape, 4 * d, 4 * dv)
        timed[("flash_attention", label, "f32")] = (t_k, t_p, b_ms, by, b_cc, t_l)
        print(f"    kernel {t_k * 1e3:10.2f} us  plain {t_p * 1e3:11.2f} us  bound "
              f"{b_ms * 1e3:9.2f} us ({by}; CUDA-core f32 {b_cc * 1e3:.2f} us)  library "
              f"{t_l * 1e3:.2f} us (SDPA, {'is_causal' if q0 == 0 else 'explicit mask'}, "
              f"expanded KV in q's dtype)", flush=True)
        del y, y_plain, last
        if d != dv:
            continue
        for pool in QUANT_POOLS:
            spec = _kv_spec(pool)
            (kq, ks), (vq, vs) = quantize_kv(k, spec), quantize_kv(v, spec)
            kd, vd = dequantize_kv(kq, ks, spec, d), dequantize_kv(vq, vs, spec, d)
            args = (q, kq, ks, vq, vs, scale, spec)
            y = flash_attn.flash_attention_quant(*args, q_start=qs)
            y7 = flash_attn.flash_attention(q, kd, vd, scale, q_start=qs)
            last = None if qs is None else flash_attn.flash_attention_quant(
                q[:, -1:].contiguous(), *args[1:], q_start=one_qs)
            torch.cuda.synchronize()
            y_plain = flash_attn.flash_attention_quant_plain(*args, q_start=qs)
            if not q0:
                whole[(label, pool)] = y
            rows = chunk_rows(y, whole.get((parent, pool)), q0, sq, last)
            _prefill_gate(worst, "flash_attention_quant", label, pool, y, y_plain,
                          _flash_tolerance(q, kd, vd, scale, y_plain, q0),
                          torch.equal(y, y7), rows)
            t_k = time_ms(lambda: flash_attn.flash_attention_quant(*args, q_start=qs), flush)
            t_p = time_ms(lambda: flash_attn.flash_attention_quant_plain(*args, q_start=qs),
                           flush)
            t_c = _sdpa_timer(q, kd, vd, q0, scale, flush)
            row = spec.packed_head_dim(d) + 4 * spec.n_groups(d)
            b_ms, by, b_cc = _prefill_bound(shape, row, row)
            timed[("flash_attention_quant", label, pool)] = (t_k, t_p, b_ms, by, b_cc, t_c)
            print(f"    kernel {t_k * 1e3:10.2f} us  plain {t_p * 1e3:11.2f} us  bound "
                  f"{b_ms * 1e3:9.2f} us ({by}; CUDA-core f32 {b_cc * 1e3:.2f} us)  library "
                  f"none (context: SDPA on a pre-dequantized KV-expanded copy "
                  f"{t_c * 1e3:.2f} us)", flush=True)
            del kq, ks, vq, vs, kd, vd, y, y7, y_plain, last
    return worst, timed


def phase_gemma(device):
    """Phase 14: (a) :func:`phase_gemma_kernels`; (b) Gemma-7b at full width
    (GEMMA_LAYERS layers; random bf16 weights from seed 0, RTN + SVD
    W4A4+LRC on the card, the bf16 weights freed) served on phase 4's
    traffic: ``health()`` must show prefill attention on #7 undemoted and
    every site on the chained path, and :func:`phase_serve` holds the
    launches exact; (c) two of phase 10's prompts (777, 130 tokens) whole
    and in 100-row chunks on f32 and int8 pools, whose greedy streams must
    be bitwise equal across the chunk widths; (d) the engine's deadlines on
    the card: a 1e-9 s deadline times out as ``deadline``, a -1 s one is
    rejected ``bad_deadline``, a finished record carries its timings.
    Returns the phase's stats and the kernels' checks."""
    import numpy as np
    import torch

    from repro_torch.serve.engine import Request, RequestState, ServeEngine

    t0 = time.perf_counter()
    print("  (a) kernels #7 and #8 at head dims up to 128, then at 256", flush=True)
    worst, timed = phase_gemma_kernels(device)
    out = {"kernels_s": time.perf_counter() - t0}

    print(f"  (b) Gemma-7b, {GEMMA_LAYERS} layers, served (chained path)", flush=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    gcfg, gparams = build_model(device, "gemma-7b", GEMMA_LAYERS)
    out["build_s"] = time.perf_counter() - t1
    gc.collect()
    torch.cuda.empty_cache()
    out["weights_gb"] = torch.cuda.memory_allocated() / 1e9
    print(f"  quantized weights resident: {out['weights_gb']:.2f} GB (the bf16 weights "
          f"freed)", flush=True)
    health = ServeEngine(gcfg, gparams, batch_slots=SLOTS, max_seq=64, page_size=PAGE,
                         prefill_chunk=CHUNK, device=device).health()
    paths = {site["path"] for site in health["decode_plan"]}
    if health["prefill_attention"] != {"route": "kernel", "kernel": "flash_attention",
                                       "kv": "f32", "demoted": None} or paths != {"chained"}:
        raise SystemExit(f"Gemma-7b: prefill attention {health['prefill_attention']} "
                         f"or site paths {paths} are not the kernel route and chained")
    counts, out["serve"] = phase_serve(gcfg, gparams, device,
                                       ["fused_prologue", "w4a4_lowrank_matmul"])

    print("  (c) prompts of 777 and 130 tokens, whole and in 100-row chunks", flush=True)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, gcfg.vocab_size, n).astype(np.int32) for n in LONG_PROMPTS]
    prompts = [p for p in prompts if len(p) in GROUP_LONG_PROMPTS]
    long_counts = {}
    for pool in ("f32", "int8"):
        streams = {}
        for chunk in LONG_CHUNKS:
            streams[chunk], out[f"long/{pool}/{chunk}"], _ = _serve_long(
                gcfg, gparams, device, prompts, pool, chunk, "kernel")
            for name, n in out[f"long/{pool}/{chunk}"]["launches"].items():
                long_counts[name] = long_counts.get(name, 0) + n
        same = streams[None] == streams[LONG_CHUNKS[1]]
        print(f"  (c) {pool}: greedy streams chunk None vs {LONG_CHUNKS[1]} "
              f"{'bitwise equal' if same else 'DIFFER'}", flush=True)
        if not same:
            raise SystemExit(f"Gemma-7b: the {pool} streams depend on the prefill chunk width")
    pool_bytes = out["long/f32/None"]["bytes_per_token"]
    print(f"  f32 pool: {pool_bytes} B per token", flush=True)

    print("  (d) deadlines on the card", flush=True)
    eng = ServeEngine(gcfg, gparams, batch_slots=SLOTS, max_seq=64, page_size=PAGE,
                      prefill_chunk=CHUNK, device=device)
    rng = np.random.default_rng(0)
    for rid, deadline in ((0, None), (1, 1e-9), (2, -1.0), (3, None)):
        eng.submit(Request(rid=rid, prompt=rng.integers(0, gcfg.vocab_size, PROMPT_LEN)
                           .astype(np.int32), max_new_tokens=4, deadline_s=deadline))
    reset_launches()
    done = eng.run()
    torch.cuda.synchronize()
    deadline_counts = launches()
    timings = {rid: rec.timings for rid, rec in done.items()}
    ok = (done[1].status is RequestState.TIMED_OUT and done[1].error_kind == "deadline"
          and done[2].status is RequestState.REJECTED and done[2].error_kind == "bad_deadline"
          and all(done[r].ok and set(timings[r]) == {"queue_s", "first_token_s", "total_s"}
                  for r in (0, 3))
          and deadline_counts["flash_attention"]
          == gcfg.n_layers * eng.counters["prefill_calls"])
    print(f"  rid 1 {done[1].status.value} ({done[1].error_kind}: {done[1].error}); rid 2 "
          f"{done[2].status.value} ({done[2].error_kind}); timings {timings}; "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit("Gemma-7b: the engine's deadlines or timings are wrong on the card")
    out["deadlines"] = {rid: {"status": rec.status.value, "error_kind": rec.error_kind,
                              "timings": rec.timings} for rid, rec in done.items()}
    del eng, gparams
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    for name, n in deadline_counts.items():
        counts[name] = counts.get(name, 0) + n + long_counts.get(name, 0)
    return out, worst, timed, counts


def add_gemma_entries(kernels, worst, timed, counts):
    """The ``d256`` sub-entry of the dense flash kernels: Gemma-7b's whole
    2048-token prompt (f32 q; #8 over int8 codes), its launches in phase
    14's main paths, which the entries' own ``launches`` then include, and
    the largest |kernel - plain| of phase 14(a).  Phase 14's launches of
    #2, #3, #6 and #9 join their entries too."""
    at = ("Gemma-7b's heads, B 1 S 2048 H 16 KH 16 D 256, f32 q, L2 flushed; launches "
          "from phase 14's serving, long prompts and deadline run")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "bound_cuda_core_ms")
    for entry in kernels:
        name = entry["name"]
        if name in ("fused_prologue", "w4a4_lowrank_matmul", "paged_flash_attention",
                    "paged_flash_attention_quant"):
            entry["launches"] += counts[name]
        if name not in worst:
            continue
        quant = name.endswith("quant")
        last = "context_sdpa_ms" if quant else "library_ms"
        t_k, t_p, b_ms, by, b_cc, t_l = timed[(name, "gemma", "int8" if quant else "f32")]
        entry["d256"] = {
            "ms": t_k, "plain_ms": t_p, "bound_ms": b_ms, "bound_by": by,
            "bound_cuda_core_ms": b_cc, "library_ms": None if quant else t_l,
            "launches": counts[name], "max_abs_err": worst[name],
            "at": at + ("; library none (context_sdpa_ms: SDPA over a pre-dequantized "
                        "KV-expanded copy)" if quant else
                        "; library: SDPA is_causal on an expanded-KV copy"),
            "shapes": {f"{label}-{p}": dict(zip(keys + (last,), v))
                       for (n, label, p), v in timed.items() if n == name},
        }
        if quant:
            entry["d256"]["context_sdpa_ms"] = t_l
        entry["launches"] += counts[name]
        entry["max_abs_err"] = max(entry["max_abs_err"], worst[name])


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 15: the serving contracts (faults and retries, crash recovery, CLI)
# ---------------------------------------------------------------------------

# the reference's chaos matrix (tests/test_serve_faults.py), each row aimed
# at CHAOS_TARGETS with more repeats than the engine's retry budget
CHAOS_MATRIX = (("exception", "prefill"), ("exception", "decode"),
                ("exception", "sampling"), ("nan_logits", "prefill"),
                ("nan_logits", "decode"), ("inf_logits", "decode"),
                ("cache_corruption", "decode"))
CHAOS_TARGETS = (2, 5)
MAX_RETRIES = 2    # the engine's default retry budget
SPLIT_CHUNK = 4    # a prefill chunk that splits the 12-token prompts in three
STALE_CALL = 5     # rid 0's decode call of step 6


def _timed_journal(path):
    """An fsync'd ``JournalWriter`` that sums the host seconds its appends
    (write and fsync) take, in ``seconds``."""
    from repro_torch.serve.journal import JournalWriter

    class Timed(JournalWriter):
        seconds = 0.0

        def append(self, kind, **fields):
            t0 = time.perf_counter()
            try:
                return super().append(kind, **fields)
            finally:
                self.seconds += time.perf_counter() - t0

    return Timed(path, fsync=True, overwrite=True)


def _contract_engine(cfg, params, device, kv_spec=None, prefill_chunk=CHUNK, **kw):
    """Phase 4's engine (its traffic submitted) with the contracts' knobs
    ``kw``."""
    from repro_torch.serve.engine import Request, ServeEngine

    eng = ServeEngine(cfg, params, batch_slots=SLOTS, max_seq=64, page_size=PAGE,
                      prefill_chunk=prefill_chunk, device=device, kv_spec=kv_spec,
                      max_retries=MAX_RETRIES, **kw)
    for i, p in enumerate(serve_prompts(cfg)):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS))
    return eng


def _run_counted(cfg, eng, kernels, what, max_steps=1024):
    """``eng.run()``, its launches held exact against the model calls it
    made (every attempt, retried or not)."""
    import torch

    before = dict(eng.counters)
    reset_launches()
    done = eng.run(max_steps)
    torch.cuda.synchronize()
    counts = launches()
    want = served_launches(cfg, eng.health(),
                           eng.counters["decode_calls"] - before["decode_calls"],
                           eng.counters["prefill_calls"] - before["prefill_calls"],
                           kernels, counts)
    if counts != want:
        raise SystemExit(f"contracts ({what}): launches {counts} are not the "
                         f"model calls' {want}")
    return done


def _check_streams(done, baseline, what, targets=(), kind=None):
    """Every untargeted request FINISHED with its fault-free stream; every
    target FAILED after the whole retry budget (with ``kind`` if given)."""
    from repro_torch.serve.lifecycle import RequestState

    if sorted(done) != sorted(baseline):
        raise SystemExit(f"contracts ({what}): records for {sorted(done)}, "
                         f"want {sorted(baseline)}")
    for rid, rec in done.items():
        if rid in targets:
            kinds = (kind,) if kind else ("injected", "non_finite_logits")
            if (rec.status is not RequestState.FAILED or rec.error_kind not in kinds
                    or rec.retries != MAX_RETRIES):
                raise SystemExit(f"contracts ({what}): target {rid} ended "
                                 f"{rec.status} [{rec.error_kind}] after {rec.retries} "
                                 f"retries; want failed {kinds} after {MAX_RETRIES}")
        elif rec.status is not RequestState.FINISHED or rec.out_tokens != baseline[rid]:
            raise SystemExit(f"contracts ({what}): rid {rid} ended {rec.status} with "
                             f"{rec.out_tokens}; want the fault-free {baseline[rid]}")


def _check_pool(eng, what):
    """Allocator invariants, every page back, no NaN left in the pool."""
    eng.alloc.check()
    if eng.alloc.free_pages != eng.alloc.capacity:
        raise SystemExit(f"contracts ({what}): {eng.alloc.used_pages} pages held "
                         f"after the run")
    for name, leaf in eng.pool.items():
        if leaf.is_floating_point() and bool(leaf.isnan().any()):
            raise SystemExit(f"contracts ({what}): NaN left in the pool's {name}")


def _chaos(cfg, params, device, kernels, baseline):
    """(a): the chaos matrix, a sampled injector and transient faults."""
    from repro_torch.serve.faults import FaultInjector, FaultSpec

    out = {}
    for kind, ph in CHAOS_MATRIX:
        what = f"{kind} at {ph}"
        inj = FaultInjector([FaultSpec(kind, ph, rid, at_call=0 if ph == "prefill" else rid % 2,
                                       repeat=MAX_RETRIES + 2) for rid in CHAOS_TARGETS])
        eng = _contract_engine(cfg, params, device, injector=inj)
        done = _run_counted(cfg, eng, kernels, what)
        # a poisoned page's NaN must reach its own row's logits on the
        # kernel path (an amax or a code conversion that drops it would
        # let the victim finish)
        _check_streams(done, baseline, what, CHAOS_TARGETS,
                       "non_finite_logits" if kind == "cache_corruption" else None)
        _check_pool(eng, what)
        out[f"{kind}-{ph}"] = {k: eng.counters[k] for k in
                               ("retries", "failed", "finished", "decode_calls",
                                "prefill_calls")}
        print(f"  chaos {what}: targets {list(CHAOS_TARGETS)} failed "
              f"[{done[CHAOS_TARGETS[0]].error_kind}] after {MAX_RETRIES} retries, "
              f"{N_REQUESTS - len(CHAOS_TARGETS)} streams bitwise phase 4's; "
              f"{out[f'{kind}-{ph}']}", flush=True)
    inj = FaultInjector.sample(range(N_REQUESTS), k=2, seed=15, repeat=MAX_RETRIES + 2)
    eng = _contract_engine(cfg, params, device, injector=inj)
    done = _run_counted(cfg, eng, kernels, "sampled injector")
    _check_streams(done, baseline, "sampled injector", inj.targets)
    _check_pool(eng, "sampled injector")
    out["sampled"] = {"specs": [(s.kind, s.phase, s.rid, s.at_call) for s in inj.specs]}
    print(f"  sampled injector (seed 15): {out['sampled']['specs']} failed, the rest "
          f"bitwise phase 4's", flush=True)
    for kind, ph, rid, at_call, chunk in (("exception", "decode", 3, 2, CHUNK),
                                          ("cache_corruption", "decode", 3, 2, CHUNK),
                                          ("cache_corruption", "prefill", 6, 1, SPLIT_CHUNK)):
        what = f"transient {kind} at {ph}"
        inj = FaultInjector([FaultSpec(kind, ph, rid, at_call=at_call)])
        eng = _contract_engine(cfg, params, device, injector=inj, prefill_chunk=chunk)
        done = _run_counted(cfg, eng, kernels, what)
        _check_streams(done, baseline, what)
        _check_pool(eng, what)
        if done[rid].retries != 1 or not inj.fired:
            raise SystemExit(f"contracts ({what}): rid {rid} retried "
                             f"{done[rid].retries} times, fired {inj.fired}")
        out[f"transient-{kind}-{ph}"] = {"retries": eng.counters["retries"]}
        print(f"  {what} (rid {rid}, chunk {chunk}): retried once, all "
              f"{N_REQUESTS} streams bitwise phase 4's (pages rolled back)", flush=True)
    return out


def _recover(cfg, params, device, kernels, baseline, workdir, what, *, crash,
             snapshot_every=0, snapshots=True, kv_spec=None, prefill_chunk=CHUNK):
    """Serve the traffic journaled (fsync'd) until ``crash`` (a FaultSpec)
    kills the engine; ``ServeEngine.restore`` on the card; every
    rid terminal exactly once in the journal, journal tokens == records ==
    the fault-free streams, launches exact, and a pool restored from a
    snapshot bitwise the pool that snapshot saved."""
    import torch

    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.faults import FaultInjector, SimulatedCrash
    from repro_torch.serve.journal import JournalWriter, collate, read_journal

    jpath = workdir / "journal.wal"
    snap_dir = str(workdir / "snaps") if snapshots else None
    journal = JournalWriter(jpath, fsync=True)
    eng = _contract_engine(cfg, params, device, kv_spec=kv_spec,
                           prefill_chunk=prefill_chunk, journal=journal,
                           snapshot_dir=snap_dir, snapshot_every=snapshot_every,
                           injector=FaultInjector([crash]))
    saved = {}
    take = eng.snapshot

    def snapshot():  # as the engine's, keeping what it saved and its cost
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = take()
        seconds = time.perf_counter() - t0
        saved.update(step=eng.counters["steps"], seconds=seconds,
                     bytes=sum(f.stat().st_size for f in Path(path).iterdir()),
                     pool={n: leaf.clone() for n, leaf in eng.pool.items()})
        return path

    eng.snapshot = snapshot
    try:
        eng.run()
    except SimulatedCrash as e:
        print(f"  {what}: {e} at step {eng.counters['steps']}", flush=True)
    else:
        raise SystemExit(f"contracts ({what}): the crash point was never hit")
    finally:
        journal.close()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng2 = ServeEngine.restore(cfg, params, jpath, snapshot_dir=snap_dir,
                               max_retries=MAX_RETRIES, device=device)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    col = collate(read_journal(jpath).records)
    marker = col.recovers[-1]
    # requeued requests with journaled tokens: fed through decode again
    replayed = [rid for rid in marker["requeued"] if col.tokens.get(rid)]
    step = marker["snapshot_step"]
    if snapshots and step != saved.get("step"):
        raise SystemExit(f"contracts ({what}): restored snapshot step {step}, "
                         f"the last one saved was {saved.get('step')}")
    if step is not None:
        for name, leaf in saved["pool"].items():
            if eng2.pool[name].device != leaf.device or not torch.equal(eng2.pool[name], leaf):
                raise SystemExit(f"contracts ({what}): the restored pool's {name} is "
                                 f"not bitwise the one snapshot {step} saved")
    done = _run_counted(cfg, eng2, kernels, what)
    eng2.journal.close()
    col = collate(read_journal(jpath).records)
    if sorted(col.terminals) != list(range(N_REQUESTS)):
        raise SystemExit(f"contracts ({what}): journaled terminals {sorted(col.terminals)}")
    for rid, rec in done.items():
        if col.tokens.get(rid, []) != rec.out_tokens:
            raise SystemExit(f"contracts ({what}): rid {rid}'s journal stream is not "
                             f"its record's")
    _check_streams(done, baseline, what)
    _check_pool(eng2, what)
    out = {"snapshot_step": step, "resumed": marker["resumed"],
           "requeued": marker["requeued"], "replayed": replayed, "restore_s": restore_s,
           "decode_calls_after": eng2.counters["decode_calls"]}
    if saved:
        out.update(snapshot_s=saved["seconds"], snapshot_bytes=saved["bytes"])
    print(f"  {what}: restored (snapshot step {step}, resumed {marker['resumed']}, "
          f"requeued {marker['requeued']}, replayed {replayed}) in {restore_s:.3f} s; every rid terminal "
          f"once, streams bitwise the fault-free run's" + (", pool bitwise the snapshot's"
                                                  if step is not None else ""), flush=True)
    return out


def phase_contracts(device, card, cfg, qparams, smol_base, pcfg, pparams, phi3_base):
    """Phase 15: the serving contracts on the card (see the module
    docstring); every check fatal."""
    import tempfile

    import torch

    from repro_torch.launch.serve import main as serve_main
    from repro_torch.serve.faults import FaultSpec

    smol, chained = ["fused_w4a4_lrc"], ["fused_prologue", "w4a4_lowrank_matmul"]
    int8 = _kv_spec("int8")
    out = {"card": card}
    print("  (a) faults and retries, SmolLM-135M:", flush=True)
    out["chaos"] = _chaos(cfg, qparams, device, smol, smol_base)

    print("  (b) crash recovery, SmolLM-135M:", flush=True)
    rec = out["recovery"] = {}
    with tempfile.TemporaryDirectory(prefix="contracts_") as tmp:
        root = Path(tmp)
        for name, kw in (
                ("decode, snapshots every step", dict(
                    crash=FaultSpec("process_crash", "decode", 2, at_call=5),
                    snapshot_every=1)),
                ("prefill (chunk 4), snapshots every step", dict(
                    # the third chunk: the first two ran in the step that
                    # admitted rid 5, so the snapshot holds its offset 8
                    crash=FaultSpec("process_crash", "prefill", 5, at_call=2),
                    snapshot_every=1, prefill_chunk=SPLIT_CHUNK)),
                ("decode, journal only", dict(
                    crash=FaultSpec("process_crash", "decode", 1, at_call=6),
                    snapshots=False)),
                ("stale snapshot", dict(
                    # snapshots every 4 steps: the crash in step 6 leaves
                    # the journal a step ahead of step 4's
                    crash=FaultSpec("process_crash", "decode", 0, at_call=STALE_CALL),
                    snapshot_every=4))):
            workdir = root / f"smol{len(rec)}"
            rec[name] = _recover(cfg, qparams, device, smol, smol_base, workdir,
                                 f"SmolLM crash {name}", **kw)
        if not rec["decode, journal only"]["replayed"] or rec["stale snapshot"]["resumed"]:
            raise SystemExit("contracts: the journal-only restore replayed nothing, or the "
                             "stale snapshot's slots resumed in place")

        print("  (c) Phi-3-mini, int8 pool:", flush=True)
        out["phi3_int8"] = {"crash": _recover(
            pcfg, pparams, device, chained, phi3_base, root / "phi3",
            "Phi-3 int8 crash at decode, snapshots every step", kv_spec=int8,
            crash=FaultSpec("process_crash", "decode", 2, at_call=5), snapshot_every=1)}
        from repro_torch.serve.faults import FaultInjector

        inj = FaultInjector([FaultSpec("cache_corruption", "decode", 3, at_call=2)])
        eng = _contract_engine(pcfg, pparams, device, kv_spec=int8, injector=inj)
        done = _run_counted(pcfg, eng, chained, "Phi-3 int8 transient cache_corruption")
        _check_streams(done, phi3_base, "Phi-3 int8 transient cache_corruption")
        _check_pool(eng, "Phi-3 int8 transient cache_corruption")
        if done[3].retries != 1:
            raise SystemExit(f"contracts: Phi-3 rid 3 retried {done[3].retries} times")
        out["phi3_int8"]["transient_cache_corruption"] = {"retries": eng.counters["retries"]}
        print("  Phi-3 int8 transient cache_corruption at decode: the scale planes "
              "rolled back, all streams bitwise phase 8's", flush=True)

        print("  (d) the serving CLI's harnesses (SmolLM-135M reduced and at its "
              "published widths, W4A4+LRC):", flush=True)
        out["cli"] = {}
        for width in ("--reduced", "--full"):
            for name, argv in (("chaos", ["--inject-faults", "2", "--parity-check"]),
                               ("crash", ["--crash-after", "2", "--snapshot-every", "4",
                                          "--parity-check",
                                          "--ckpt-dir", str(root / f"cli{width}")])):
                rc = serve_main([width, "--quantize", "--device", device] + argv)
                if rc != 0:
                    raise SystemExit(f"contracts: the CLI's {name} harness ({width}) "
                                     f"returned {rc}")
                out["cli"][f"{name} {width[2:]}"] = rc

        print("  (e) the journal's cost, SmolLM-135M (phase 4's traffic):", flush=True)
        out["journal"] = {"off": [], "on": [], "append": []}
        for on in (False, True, False, True):
            journal = _timed_journal(root / "cost.wal") if on else None
            eng = _contract_engine(cfg, qparams, device, journal=journal)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            done = eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            _check_streams(done, smol_base, f"journal {'on' if on else 'off'}")
            n_tok = sum(r.new_tokens for r in done.values())
            out["journal"]["on" if on else "off"].append(n_tok / wall)
            if on:
                journal.close()
                out["journal"]["append"].append(
                    {"records": journal.seq, "tokens": n_tok, "seconds": journal.seconds,
                     "ms_per_record": journal.seconds / journal.seq * 1e3,
                     "ms_per_token": journal.seconds / n_tok * 1e3,
                     "share_of_run": journal.seconds / wall})
    sn = rec["decode, snapshots every step"]
    ph = out["phi3_int8"]["crash"]
    print(f"  [{card}] snapshot: SmolLM-135M f32 pool {sn['snapshot_bytes']} B in "
          f"{sn['snapshot_s'] * 1e3:.1f} ms; Phi-3-mini int8 pool {ph['snapshot_bytes']} B "
          f"in {ph['snapshot_s'] * 1e3:.1f} ms", flush=True)
    print(f"  [{card}] restore: SmolLM-135M " + ", ".join(
        f"{k} {v['restore_s']:.3f} s" for k, v in rec.items())
        + f"; Phi-3-mini int8 {ph['restore_s']:.3f} s", flush=True)
    print(f"  [{card}] phase 4's traffic with the journal off / on (fsync): "
          + " / ".join(f"{', '.join(f'{t:.1f}' for t in out['journal'][k])} tok/s"
                       for k in ("off", "on")), flush=True)
    for a in out["journal"]["append"]:
        print(f"  [{card}] journal appends (write + fsync): {a['records']} records, "
              f"{a['seconds'] * 1e3:.2f} ms in all, {a['ms_per_record']:.4f} ms a record, "
              f"{a['ms_per_token']:.4f} ms a token, {a['share_of_run'] * 100:.2f} % of "
              f"the run", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 16: training on the card and the paper's Table 1 on a trained model
# ---------------------------------------------------------------------------

# (a) one train step of the reduced model (f32, TF32 off) on the card
# against the same step on the CPU: cuBLAS and the CPU's BLAS sum in other
# orders, so the loss is held within relative 1e-5 and every gradient leaf
# within 1e-4 of its largest element (on the CPU the port against the JAX
# reference, two frameworks' f32 orders, measured 2e-7 and 1e-6)
STEP_LOSS_REL = 1e-5
STEP_GRAD_REL = 1e-4
# (b) SmolLM-135M at its published widths and depth, the reference
# launcher's defaults: batch 16 x seq 128, lr 3e-4
TRAIN_STEPS_FULL = 30
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 16, 128, 3e-4
# (c) the resume check: 6 steps straight against 3, a restart, then 3
RESUME_STEPS, RESUME_EVERY = 6, 3


def _train_configs():
    """(the reduced f32 model of (a) and (c), the full model of (b))."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import reduced

    return reduced(get_config("smollm-135m")), get_config("smollm-135m")


def _state_to(state, device):
    from repro_torch.train.optimizer import AdamWState, tree_map
    from repro_torch.train.steps import TrainState

    to = lambda t: t.to(device)
    return TrainState(params=tree_map(to, state.params),
                      opt=AdamWState(step=to(state.opt.step), mu=tree_map(to, state.opt.mu),
                                     nu=tree_map(to, state.opt.nu)))


def _state_leaves(state):
    from repro_torch.train.optimizer import tree_leaves

    return tree_leaves([state.params, state.opt.mu, state.opt.nu, state.opt.step])


def _step_card_vs_cpu(device, cfg, label="(a)"):
    """(a): the loss and every gradient leaf of one batch, then one whole
    train step, on the card and on the CPU from the same state (printed
    under ``label``)."""
    import torch

    from repro_torch.data.loader import batches
    from repro_torch.train import steps
    from repro_torch.train.optimizer import tree_leaves

    cpu = steps.init_train_state(cfg, seed=0, device="cpu")
    card = _state_to(cpu, device)
    _, batch = next(batches(cfg, 8, 64, seed=1, device="cpu"))
    card_batch = {"tokens": batch["tokens"].to(device)}
    loss_c, grads_c = steps.value_and_grad(cfg, cpu.params, batch)
    loss_g, grads_g = steps.value_and_grad(cfg, card.params, card_batch)
    loss_rel = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    grad_rel = max(float((g.cpu() - c).abs().max() / c.abs().max())
                   for g, c in zip(tree_leaves(grads_g), tree_leaves(grads_c)))
    fn = steps.make_train_step(cfg, base_lr=1e-3, warmup=0, total_steps=10, remat="none")
    (new_c, m_c), (new_g, m_g) = fn(cpu, batch), fn(card, card_batch)
    norm_rel = abs(float(m_g["grad_norm"]) - float(m_c["grad_norm"])) / float(m_c["grad_norm"])
    finite = all(bool(torch.isfinite(t).all()) for t in _state_leaves(new_g))
    print(f"  {label} one step, reduced f32 model, B 8 x S 64: loss card {float(loss_g):.7f} "
          f"CPU {float(loss_c):.7f} (rel {loss_rel:.2e}, limit {STEP_LOSS_REL:g}); worst "
          f"grad leaf {grad_rel:.2e} of its largest element (limit {STEP_GRAD_REL:g}); "
          f"grad norm rel {norm_rel:.2e}; new state finite {finite}", flush=True)
    if not (loss_rel <= STEP_LOSS_REL and grad_rel <= STEP_GRAD_REL
            and norm_rel <= STEP_LOSS_REL and finite):
        raise SystemExit(f"{label}: the card's train step disagrees with the CPU's")
    return dict(loss_rel=loss_rel, grad_rel=grad_rel, grad_norm_rel=norm_rel)


def _train_full(device, cfg):
    """(b): ``train`` at full width and depth; no kernel may launch."""
    import math

    import torch

    from repro_torch.train.trainer import train

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, losses, watchdog = train(cfg, steps=TRAIN_STEPS_FULL, global_batch=TRAIN_BATCH,
                                    seq_len=TRAIN_SEQ, lr=TRAIN_LR, device=device,
                                    log=lambda s: print(f"    {s}", flush=True))
    wall = time.perf_counter() - t0
    counts = launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    del state
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    step_ms = statistics.median(watchdog.times[1:]) * 1e3
    out = dict(steps=len(losses), first5=first, last5=last, losses=losses,
               first_step_ms=watchdog.times[0] * 1e3, step_ms=step_ms,
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3, peak_gib=peak,
               wall_s=wall, params_dtype=cfg.dtype, launches=sum(counts.values()))
    print(f"  (b) SmolLM-135M full width and depth ({cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.dtype} params, f32 moments), B {TRAIN_BATCH} x S {TRAIN_SEQ}, lr "
          f"{TRAIN_LR:g}: loss {losses[0]:.4f} -> {losses[-1]:.4f} (mean of first 5 "
          f"{first:.4f}, last 5 {last:.4f}); step {step_ms:.1f} ms median (first "
          f"{out['first_step_ms']:.0f} ms), {out['tokens_per_s']:,.0f} tokens/s, peak "
          f"{peak:.2f} GiB, {wall:.1f} s; kernel launches {out['launches']}", flush=True)
    if not all(math.isfinite(v) for v in losses):
        raise SystemExit("phase 16(b): a training loss is not finite")
    if not last < first:
        raise SystemExit("phase 16(b): the loss did not fall over the run")
    if out["launches"]:
        raise SystemExit(f"phase 16(b): training launched kernels: "
                         f"{ {k: v for k, v in counts.items() if v} }")
    return out


def _resume(device, cfg):
    """(c): 6 steps straight against 3, a restart from the step-3
    checkpoint, then 3 more: bitwise the same params and moments.  A second
    straight run says whether a difference is the card's or the resume's."""
    import tempfile

    import torch

    from repro_torch.train.trainer import train

    kw = dict(steps=RESUME_STEPS, global_batch=4, seq_len=32, lr=1e-2, device=device,
              log=lambda s: None)
    with tempfile.TemporaryDirectory(prefix="resume_") as tmp:
        straight, hist_a, _ = train(cfg, ckpt_dir=f"{tmp}/a", ckpt_every=100, **kw)
        again, _, _ = train(cfg, **kw)
        train(cfg, ckpt_dir=f"{tmp}/b", ckpt_every=RESUME_EVERY,
              **dict(kw, steps=RESUME_EVERY))
        seen = []
        resumed, hist_b, _ = train(cfg, ckpt_dir=f"{tmp}/b", ckpt_every=RESUME_EVERY,
                                   **dict(kw, log=seen.append))
    same = lambda x, y: all(a.dtype == b.dtype and torch.equal(a, b)
                            for a, b in zip(_state_leaves(x), _state_leaves(y)))
    bitwise, repeat = same(straight, resumed), same(straight, again)
    print(f"  (c) resume: {RESUME_STEPS} steps straight vs {RESUME_EVERY} + restart "
          f"({seen[0] if seen else 'no resume'}) + {RESUME_STEPS - RESUME_EVERY}: params "
          f"and moments bitwise {bitwise}, losses {hist_a[RESUME_EVERY:] == hist_b}; two "
          f"straight runs bitwise {repeat}", flush=True)
    if not (bitwise and seen[:1] == [f"[resume] from step {RESUME_EVERY}"]):
        raise SystemExit("phase 16(c): the resumed run is not bitwise the straight one")
    return dict(bitwise=bitwise, straight_runs_bitwise=repeat)


def _uncounted(fn, *args):
    """``fn(*args)`` with every kernel count put back after it: a launch
    made to compare a kernel with another version is not the main path's."""
    saved = [(mod, dict(mod.LAUNCHES)) for mod in _kernel_modules()]
    try:
        return fn(*args)
    finally:
        for mod, counts in saved:
            mod.LAUNCHES.update(counts)


def _checked_fused(site):
    """A stand-in for ``ops.fused_w4a4_lrc`` that launches #1, as the main
    path does, and holds each call's output to the plain version within
    ``lr_tolerance`` and bitwise to the chained path (#3 then #2) on the
    same inputs, those comparisons uncounted.  ``site`` gathers the calls,
    the worst error, the misses and the shapes seen."""
    import torch

    from repro_torch.bench.common import lr_tolerance
    from repro_torch.kernels import fused_gemm

    def checked(x, v, wp, sw, u, bits=4, clip_ratio=1.0, rotate=False, group=None):
        y = fused_gemm.fused_w4a4_lrc(x, v, wp, sw, u, bits, clip_ratio, rotate, group)
        yp = _uncounted(fused_gemm.fused_w4a4_lrc_plain, x, v, wp, sw, u, bits, clip_ratio,
                        rotate, group)
        y_ch = _uncounted(_fused_chained, x, v, wp, sw, u, rotate, group, bits, clip_ratio)
        r = 0 if v is None else v.shape[1]
        err = (y - yp).abs()
        site["calls"] += 1
        site["worst"] = max(site["worst"], err.max().item())
        site["bad"] += int(not bool((err <= lr_tolerance(x, v, u, x.shape[1], r, yp)).all()))
        site["not_chained"] += int(not torch.equal(y, y_ch))
        site["shapes"].add((x.shape[0], x.shape[1], wp.shape[1], r, group))
        return y

    return checked


def _lr_dropped(fraction):
    """A faulty stand-in for ``ops.fused_w4a4_lrc``: #1 with only the first
    ``fraction`` of the LR term's ranks (0: the LR term dropped), for the
    control that the kernel column's bound must see."""
    from repro_torch.kernels import fused_gemm

    def faulty(x, v, wp, sw, u, bits=4, clip_ratio=1.0, rotate=False, group=None):
        keep = 0 if v is None else int(v.shape[1] * fraction)
        if keep:
            v, u = v[:, :keep].contiguous(), u[:, :keep].contiguous()
        else:
            v = u = None
        return fused_gemm.fused_w4a4_lrc(x, v, wp, sw, u, bits, clip_ratio, rotate, group)

    return faulty


def _outside(bound, sim, col):
    """Whether a kernel column ``col`` = (ppl, acc) is outside ``bound`` of
    its sim column ``sim``."""
    return abs(col[0] - sim[0]) > bound["ppl_rel"] * sim[0] or \
        abs(col[1] - sim[1]) > bound["acc_abs"]


def _table1(device):
    """(d): ``BENCH_CFG`` trained for ``TRAIN_STEPS`` into a temporary
    directory, then Table 1 (FP16, QuaRot, SVD, LRC (1), LRC (5)) with the
    calibration walks on the card ("auto": #7) and each model evaluated on
    the sim column (gather attention) and the kernel column (the fused
    path: #1 at every site; the kernel route: #7 in every forward).
    Launches exact, no NaN, every #1 call of the kernel column held to its
    plain version and to the chained path, the kernel column within
    ``common.KERNEL_COLUMN_BOUND`` of the sim column, and LRC (1)'s kernel
    column with half of its LR ranks or none (a faulty kernel) outside it."""
    import math
    import tempfile

    from repro_torch.bench import common, table1_w4a4
    from repro_torch.kernels import fused_gemm, ops
    from repro_torch.kernels.context import KernelContext

    stages = {}
    with tempfile.TemporaryDirectory(prefix="bench_") as tmp:
        t0 = time.perf_counter()
        cfg, params = common.get_bench_model(device=device, bench_dir=f"{tmp}/model",
                                             log=lambda s: None)
        stages["train"] = time.perf_counter() - t0
        bench = common.Bench(cfg, params, common.calib_tokens(cfg, device=device),
                             common.eval_batches(cfg, device=device), out_dir=f"{tmp}/tables")
        policy = common.make_policy("lrc")
        plans = {}
        for block, names in (("attn", ("wq", "wk", "wv", "wo")), ("mlp", ("wg", "wu", "wd"))):
            for name in names:
                k, n = params["layers"][0][block][name].shape
                for r in (0, policy.rank(k, n)):
                    plans[f"{block}/{name} r{r}"] = KernelContext().resolve_plan(
                        8 * 64, k, n, r, layer=f"{block}/{name}").path
        print(f"  (d) {common.TRAIN_STEPS} steps of BENCH_CFG ({cfg.n_layers} layers, d "
              f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} x {cfg.head_dim}) in "
              f"{stages['train']:.1f} s; each site's resolved path: {plans}", flush=True)
        qparams = {}
        quantize = table1_w4a4.quantize
        site = {"calls": 0, "worst": 0.0, "bad": 0, "not_chained": 0, "shapes": set()}

        def quantize_kept(cfg, params, policy, calib):
            qp = quantize(cfg, params, policy, calib)
            qparams[(policy.correction, policy.lrc_iters)] = qp
            return qp

        table1_w4a4.quantize, ops.fused_w4a4_lrc = quantize_kept, _checked_fused(site)
        reset_launches()
        timings = {}
        try:
            results = table1_w4a4.run(bench=bench, timings=timings)
            counts = launches()
        finally:
            table1_w4a4.quantize, ops.fused_w4a4_lrc = quantize, fused_gemm.fused_w4a4_lrc
        controls = {}
        for frac in (0.0, 0.5):
            ops.fused_w4a4_lrc = _lr_dropped(frac)
            try:
                for name, key in (("SVD", ("svd", 1)), ("LRC (1)", ("lrc", 1))):
                    controls[(name, frac)] = _uncounted(common.evaluate, bench,
                                                        qparams[key])[2:]
            finally:
                ops.fused_w4a4_lrc = fused_gemm.fused_w4a4_lrc
    n_models = len(table1_w4a4.METHODS)
    n_evals, n_layers = len(bench.evals), cfg.n_layers
    want = {"flash_attention": n_models * n_layers + (n_models + 1) * n_evals * n_layers,
            "fused_w4a4_lrc": n_models * n_evals * n_layers * 7}
    other = {k: v for k, v in counts.items() if v and k not in want}
    print(f"  launches: {dict((k, counts[k]) for k in want)} (want {want}; every calibration "
          f"walk's layer and every kernel-column forward's layer launch #7, every kernel-"
          f"column site #1); others {other or 'none'}", flush=True)
    if any(counts[k] != v for k, v in want.items()) or other:
        raise SystemExit("phase 16(d): Table 1's launches are not the exact count")
    print(f"  every #1 call of the kernel column ({site['calls']} calls at (M, K, N, R, "
          f"group) {sorted(site['shapes'], key=str)}): max |kernel - plain| "
          f"{site['worst']:.3e}, {site['bad']} outside lr_tolerance, {site['not_chained']} "
          f"not bitwise the chained path", flush=True)
    if site["calls"] != want["fused_w4a4_lrc"] or site["bad"] or site["not_chained"]:
        raise SystemExit("phase 16(d): a #1 call of the kernel column disagrees with its "
                         "plain version or the chained path")
    bound = common.KERNEL_COLUMN_BOUND
    for name, (ppl, acc, ppl_k, acc_k) in results.items():
        ok = all(math.isfinite(v) for v in (ppl, acc, ppl_k, acc_k)) and \
            abs(ppl_k - ppl) <= bound["ppl_rel"] * ppl and abs(acc_k - acc) <= bound["acc_abs"]
        t = timings[name]
        print(f"    {name:8s} sim ppl {ppl:.4f} acc {acc:.4f} | kernel ppl {ppl_k:.4f} acc "
              f"{acc_k:.4f} | calibration {t.get('quant_s', 0.0):.2f} s, evaluation "
              f"{t['eval_s']:.2f} s  {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"phase 16(d): {name}'s kernel column is not within {bound} "
                             f"of its sim column (or not finite)")
    for (name, frac), (ppl_c, acc_c) in controls.items():
        ppl, acc = results[name][:2]
        print(f"    control: {name} kernel column with {frac:.0%} of the LR ranks kept: ppl "
              f"{ppl_c:.4f} ({(ppl_c - ppl) / ppl:+.3%} of sim) acc {acc_c:.4f} "
              f"({acc_c - acc:+.4f}); outside the bound "
              f"{_outside(bound, results[name][:2], (ppl_c, acc_c))}", flush=True)
    if not all(_outside(bound, results["LRC (1)"][:2], controls[("LRC (1)", frac)])
               for frac in (0.0, 0.5)):
        raise SystemExit(f"phase 16(d): the bound {bound} cannot see LRC (1)'s LR term "
                         f"cut to half its ranks or dropped")
    closed = {col: table1_w4a4.closed_frac(results["FP16"][i], results["QuaRot"][i],
                                           results["LRC (1)"][i])
              for col, i in (("sim", 1), ("kernel", 3))}
    print(f"  LRC (1) closes {closed['sim']:.3f} of the QuaRot accuracy gap on the sim "
          f"column, {closed['kernel']:.3f} on the kernel column", flush=True)
    return dict(results=results, closed=closed, stages=stages, timings=timings,
                launches={k: counts[k] for k in want}, plans=plans,
                per_call=dict(calls=site["calls"], worst=site["worst"]),
                controls={f"{name} {frac:.0%} ranks": c for (name, frac), c in controls.items()})


def _grad_mode_refused(device):
    """One grad-mode call each into #1 and #7 with an input that requires
    grad: each must raise (no kernel has a backward), launching nothing."""
    import torch

    from repro_torch.bench.common import w4a4_problem
    from repro_torch.kernels import flash_attn, fused_gemm

    gen = torch.Generator(device=device).manual_seed(16)
    x, v, wp, sw, u = w4a4_problem(gen, 8, 128, 64, 8, torch.float32, torch.bfloat16, device)
    q, k, kv = (torch.randn((1, 16, h, 32), generator=gen, device=device) for h in (4, 2, 2))
    reset_launches()
    calls = {"fused_w4a4_lrc": lambda: fused_gemm.fused_w4a4_lrc(
                 x.requires_grad_(True), v, wp, sw, u),
             "flash_attention": lambda: flash_attn.flash_attention(
                 q.requires_grad_(True), k, kv, 0.1)}
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
            print(f"  (e) {name} under grad mode with an input that requires grad: "
                  f"RuntimeError ({e})", flush=True)
            continue
        raise SystemExit(f"phase 16(e): {name} ran under grad mode on an input that "
                         f"requires grad")
    if any(launches().values()):
        raise SystemExit("phase 16(e): a refused call launched a kernel")


def phase_train(device):
    """Phase 16: (a) one train step on the card against the CPU's; (b)
    SmolLM-135M trained at full width; (c) the bitwise resume; (d) Table 1
    on the trained benchmark model through kernels #1 and #7; (e) the
    kernel wrappers refuse autograd.  Returns the summary and Table 1's
    launches."""
    import torch

    small, full = _train_configs()
    times = {}
    t0 = time.perf_counter()
    out = {"step": _step_card_vs_cpu(device, small)}
    times["a"] = time.perf_counter() - t0
    out["full"] = _train_full(device, full)
    times["b"] = time.perf_counter() - t0 - times["a"]
    torch.cuda.empty_cache()
    out["resume"] = _resume(device, small)
    times["c"] = time.perf_counter() - t0 - times["a"] - times["b"]
    out["table1"] = _table1(device)
    times["d"] = time.perf_counter() - t0 - sum(times.values())
    _grad_mode_refused(device)
    times["e"] = time.perf_counter() - t0 - sum(times.values())
    out["seconds"] = times
    print("  phase 16 seconds: " + ", ".join(f"({k}) {v:.1f}" for k, v in times.items()),
          flush=True)
    return out, out["table1"]["launches"]


# ---------------------------------------------------------------------------
# phase 17: the moe family served (DeepSeek-V2 at full width, per-slot mode)
# ---------------------------------------------------------------------------

# DeepSeek-V2's depth served here: layer 0 (dense FFN, d_ff 12,288) and
# layer 1 (MoE: 160 routed experts top-6 and 2 shared), at full width.
# Never fewer than 2 layers, or the MoE layer is gone
DEEPSEEK_LAYERS = 2
DS_MAX_SEQ = 64
# the decode offsets #7 is held at with random inputs (the served prompts'
# 12 tokens plus up to 16 new ones)
DS_DECODE_OFFSETS = tuple(range(PROMPT_LEN, PROMPT_LEN + NEW_TOKENS))
# the slot decode calls of phase 17's profiled window
DS_PROFILED_STEPS = 2
# the reduced DeepSeek-V2 walked by _quantize_moe on the card and the CPU
DS_CALIB_SEQS, DS_CALIB_LEN = 16, 64
# the kernels of each QLinear path, one launch each per call
PATH_KERNELS = {"fused": ("fused_w4a4_lrc",),
                "chained": ("fused_prologue", "w4a4_lowrank_matmul"),
                "unfused": ("act_quant", "w4a4_lowrank_matmul")}


def _ds_sites(params):
    """(path, QLinear, calls a model call makes) for every QLinear of a
    DeepSeek tree, routed experts as one stacked site of E calls."""
    from repro_torch.quant.qlinear import QLinear

    out = []

    def visit(node, path):
        if isinstance(node, QLinear):
            calls = node.qweight.shape[0] if node.qweight.dim() == 3 else 1
            out.append(("/".join(path), node, calls))
        elif isinstance(node, dict):
            for k, v in node.items():
                visit(v, path + (k,))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                visit(v, path + (str(i),))

    for group in ("dense_layers", "moe_layers"):
        visit(params.get(group, []), (group,))
    return out


def _ds_path(q, m=1):
    """The kernel path ``q``'s calls resolve to (M does not enter it)."""
    from repro_torch.kernels import ops

    ctx = ops.DEFAULT_CONTEXT if q.ctx is None else q.ctx
    r = 0 if q.u is None else int(q.u.shape[-1])
    return ctx.resolve_plan(m, q.d_in, q.d_out, r, layer=q.name,
                            impl=None if q.impl == "pallas" else q.impl,
                            act_group=q.act_group).path


def _ds_expected(cfg, params, names, model_calls):
    """The launches ``model_calls`` model calls must make, by wrapper name
    (every name in ``names``): each kernel of a QLinear's path once per
    call (a routed expert stack: once per expert), #7 once per layer of
    each call, nothing else."""
    expected = {name: 0 for name in names}
    for _, q, calls in _ds_sites(params):
        for name in PATH_KERNELS[_ds_path(q)]:
            expected[name] += calls * model_calls
    expected["flash_attention"] = cfg.n_layers * model_calls
    return expected


def _ds_build(device):
    """DeepSeek-V2 at full width, DEEPSEEK_LAYERS layers, random bf16
    weights from seed 0, every site W4A4+LRC by RTN + SVD (rank 10 %, clip
    0.9) on the card; the bf16 weights freed.  Returns (cfg, qparams,
    stats)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model
    from repro_torch.quant.calibrate import quantize_model
    from repro_torch.quant.policy import QuantPolicy

    cfg = dataclasses.replace(get_config("deepseek-v2-236b"), n_layers=DEEPSEEK_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    bf16_gb = (torch.cuda.memory_allocated() - base) / 1e9
    policy = QuantPolicy(quant_method="rtn", correction="svd", rank_frac=0.10,
                         clip_ratio=0.9)
    t1 = time.perf_counter()
    qparams = quantize_model(cfg, params, None, policy, rotate=False)
    torch.cuda.synchronize()
    rtn_s = time.perf_counter() - t1
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    del params
    gc.collect()
    torch.cuda.empty_cache()
    q_gb = (torch.cuda.memory_allocated() - base) / 1e9
    sites = _ds_sites(qparams)
    n_calls = sum(c for _, _, c in sites)
    print(f"  {cfg.name}: {cfg.n_layers} layers ({cfg.n_dense_layers} dense, "
          f"{cfg.n_layers - cfg.n_dense_layers} MoE), d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads (q_lora {cfg.q_lora_rank}, kv_lora {cfg.kv_lora_rank}, "
          f"nope {cfg.qk_nope_dim}, rope {cfg.qk_rope_dim}, v {cfg.v_head_dim}), "
          f"{cfg.n_experts} experts top-{cfg.moe_top_k} of {cfg.d_expert}, "
          f"{cfg.n_shared_experts} shared, dense d_ff {cfg.d_ff_dense}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}", flush=True)
    print(f"  random bf16 weights {bf16_gb:.2f} GB in {init_s:.1f} s; RTN+SVD of "
          f"{len(sites)} sites ({n_calls} QLinears) in {rtn_s:.1f} s; peak "
          f"{peak_gb:.2f} GB; quantized weights resident {q_gb:.2f} GB (the bf16 "
          f"weights freed)", flush=True)
    return cfg, qparams, {"init_s": init_s, "rtn_svd_s": rtn_s, "bf16_gb": bf16_gb,
                          "peak_gb": peak_gb, "quantized_gb": q_gb,
                          "sites": len(sites), "qlinears": n_calls}


def _ds_engine(cfg, qparams, device, **kw):
    from repro_torch.serve.engine import ServeEngine

    return ServeEngine(cfg, qparams, batch_slots=SLOTS, max_seq=DS_MAX_SEQ,
                       device=device, max_retries=MAX_RETRIES, **kw)


def _ds_serve(cfg, qparams, device, prompts):
    """(a) The traffic through ``submit``/``run`` in slots mode; launches
    exact; the median ms of a slot decode call and of a prompt's prefill;
    a profiled window of slot decode calls.  Returns (counts, stats, eng)."""
    import torch

    from repro_torch.serve.engine import Request, RequestState

    warm = _ds_engine(cfg, qparams, device)
    warm.submit(Request(rid=0, prompt=prompts[0], max_new_tokens=2))
    warm.run()
    eng = _ds_engine(cfg, qparams, device)
    health = eng.health()
    if health["mode"] != "slots":
        raise SystemExit(f"DeepSeek-V2: engine mode {health['mode']!r}, want 'slots'")
    if health["decode_attention"] != {"route": "kernel", "kernel": "flash_attention",
                                      "kv": "f32", "demoted": None}:
        raise SystemExit(f"DeepSeek-V2: attention {health['decode_attention']} is not #7")
    times = {"prefill": [], "decode": []}
    for kind in times:
        inner = getattr(eng, f"_{kind}")

        def timed(*a, _inner=inner, _kind=kind, **kw):
            t = time.perf_counter()
            out = _inner(*a, **kw)
            torch.cuda.synchronize()
            times[_kind].append(time.perf_counter() - t)
            return out

        setattr(eng, f"_{kind}", timed)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS))
    reset_launches()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    bad = [r for r, rec in done.items()
           if rec.status is not RequestState.FINISHED or rec.new_tokens != NEW_TOKENS]
    if len(done) != len(prompts) or bad:
        raise SystemExit(f"DeepSeek-V2: requests {bad} did not finish: {done}")
    calls = eng.counters["decode_calls"] + eng.counters["prefill_calls"]
    expected = _ds_expected(cfg, eng.params, counts, calls)
    routes = {}
    for path, q, n in _ds_sites(eng.params):
        r = 0 if q.u is None else int(q.u.shape[-1])
        routes[path] = {"k": q.d_in, "n": q.d_out, "r": r, "calls": n,
                        "path": _ds_path(q), "impl": q.impl}
        print(f"  route {path:<32} K {q.d_in:<6} N {q.d_out:<6} R {r:<4} x{n:<4} "
              f"{routes[path]['path']}", flush=True)
    print(f"  {len(prompts)} requests x {NEW_TOKENS} tokens finished in slots mode; "
          f"counters {eng.counters}", flush=True)
    print(f"  {calls} model calls ({eng.counters['prefill_calls']} prefill, "
          f"{eng.counters['decode_calls']} decode): launches {counts}; want {expected}",
          flush=True)
    if counts != expected:
        raise SystemExit("DeepSeek-V2: the served launches are not one per kernel of "
                         "each QLinear call's path and one #7 per layer per call")
    per_call = {k: v // calls for k, v in expected.items() if v}
    stats = {"wall_s": wall, "tokens_per_s": len(prompts) * NEW_TOKENS / wall,
             "decode_call_ms": statistics.median(times["decode"]) * 1e3,
             "prefill_ms": statistics.median(times["prefill"]) * 1e3,
             "decode_calls": eng.counters["decode_calls"],
             "prefill_calls": eng.counters["prefill_calls"],
             "launches_per_call": per_call, "routes": routes, "kv": health["kv"],
             "streams": {rid: list(rec.out_tokens) for rid, rec in done.items()}}
    print(f"  slot decode call {stats['decode_call_ms']:.2f} ms (median of "
          f"{len(times['decode'])}), prefill {stats['prefill_ms']:.2f} ms per "
          f"{PROMPT_LEN}-token prompt (median of {len(times['prefill'])}); launches per "
          f"model call {per_call}; {stats['tokens_per_s']:.1f} tok/s", flush=True)
    stats.update(_ds_profile(cfg, qparams, device, prompts))
    return counts, stats


def _ds_profile(cfg, qparams, device, prompts, top=10):
    """Where a slot decode call's time goes: SLOTS requests prefilled, then
    DS_PROFILED_STEPS engine steps (SLOTS B=1 decode calls each) under
    torch.profiler (:func:`_device_profile`, per decode call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import Request

    eng = _ds_engine(cfg, qparams, device)
    for i, p in enumerate(prompts[:SLOTS]):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS))
    eng._admit()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(DS_PROFILED_STEPS):
            eng._step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    calls = DS_PROFILED_STEPS * SLOTS
    out = _device_profile(prof, wall, calls, "slot decode calls", top)
    return {"profiled_decode_call_ms": out["profiled_step_ms"],
            "device_busy_ms_per_decode_call": out["device_busy_ms_per_step"],
            "device_idle_share": out["device_idle_share"],
            "device_ops_per_decode_call": out["device_ops_per_step"],
            "top": out["top"]}


def _ds_checked(cfg, eng, device, prompt):
    """(b) One prefill call and one decode call of the served model with
    every kernel call held to its plain version (those uncounted): #3's
    codes and scales bitwise and x·V within ``xv_tolerance``; #2 within
    ``gemm_tolerance``; #1 within ``lr_tolerance``, bitwise the chained path
    and, on ``wkv_b``'s all-zero cache rows, bitwise its plain version; #7
    within ``_flash_tolerance``.  The router's inputs are kept for (d).
    Returns (stats, the captured inputs of each distinct site and of #7,
    the router rows, the router weights)."""
    import torch

    from repro_torch.bench.common import gemm_tolerance, lr_tolerance, xv_tolerance
    from repro_torch.kernels import flash_attn, fused_gemm, ops, prologue, w4a4
    from repro_torch.models import moe

    sites = {}
    captured = {"flash": []}
    router_rows = []
    first_x = {}

    def site(key):
        return sites.setdefault(key, {"calls": 0, "bad": 0, "xv": 0.0, "y": 0.0,
                                      "not_chained": 0, "zero_rows": 0,
                                      "zero_rows_bad": 0})

    def checked_prologue(x, v, bits=4, clip_ratio=1.0, rotate=False, group=None):
        xq, sx, xv = prologue.fused_prologue(x, v, bits, clip_ratio, rotate, group)
        xq_p, sx_p, xv_p = _uncounted(prologue.fused_prologue_plain, x, v, bits,
                                      clip_ratio, rotate, group)
        first_x["x"], first_x["v"] = x, v
        s = site(("prologue", x.shape[1], v.shape[1]))
        s["calls"] += 1
        bad = not (torch.equal(xq, xq_p) and torch.equal(sx, sx_p))
        err = (xv - xv_p).abs()
        s["xv"] = max(s["xv"], err.max().item())
        bad |= not bool((err <= xv_tolerance(x, v, x.shape[1], xv_p)).all())
        s["bad"] += int(bad)
        return xq, sx, xv

    def checked_gemm(xq, sx, wp, sw, xv=None, u=None, group=None):
        y = w4a4.w4a4_lowrank_matmul(xq, sx, wp, sw, xv, u, group)
        y_p = _uncounted(w4a4.w4a4_lowrank_matmul_plain, xq, sx, wp, sw, xv, u, group)
        r = 0 if xv is None else xv.shape[1]
        key = (xq.shape[1], wp.shape[1], r)
        s = site(("gemm",) + key)
        s["calls"] += 1
        err = (y - y_p).abs()
        s["y"] = max(s["y"], err.max().item())
        s["bad"] += int(not bool((err <= gemm_tolerance(xv, u, r, y_p)).all()))
        zero = (first_x["x"] == 0).all(dim=1)
        s["zero_rows"] += int(zero.sum())
        s["zero_rows_bad"] += int(not torch.equal(y[zero], y_p[zero]))
        # the last call of each shape is kept: the decode call's (M 1)
        captured[("chained",) + key] = (first_x["x"], first_x["v"], wp, sw, u)
        return y

    def checked_fused(x, v, wp, sw, u, bits=4, clip_ratio=1.0, rotate=False, group=None):
        y = fused_gemm.fused_w4a4_lrc(x, v, wp, sw, u, bits, clip_ratio, rotate, group)
        yp = _uncounted(fused_gemm.fused_w4a4_lrc_plain, x, v, wp, sw, u, bits,
                        clip_ratio, rotate, group)
        y_ch = _uncounted(_fused_chained, x, v, wp, sw, u, rotate, group, bits, clip_ratio)
        r = 0 if v is None else v.shape[1]
        s = site(("fused", x.shape[1], wp.shape[1], r))
        s["calls"] += 1
        err = (y - yp).abs()
        s["y"] = max(s["y"], err.max().item())
        s["bad"] += int(not bool((err <= lr_tolerance(x, v, u, x.shape[1], r, yp)).all()))
        s["not_chained"] += int(not torch.equal(y, y_ch))
        zero = (x == 0).all(dim=1)
        s["zero_rows"] += int(zero.sum())
        s["zero_rows_bad"] += int(not torch.equal(y[zero], yp[zero]))
        captured[("fused", x.shape[1], wp.shape[1], r)] = (x, v, wp, sw, u)
        return y

    def checked_flash(q, k, v, scale, causal=True, q_start=None):
        y = flash_attn.flash_attention(q, k, v, scale, causal, q_start)
        yp = _uncounted(flash_attn.flash_attention_plain, q, k, v, scale, causal, q_start)
        q0 = 0 if q_start is None else int(q_start.max())
        tol = _flash_tolerance(q, k, v, scale, yp, q0)
        err = (y.double() - yp.double()).abs()
        s = site(("flash", q.shape[1], k.shape[1], q0))
        s["calls"] += 1
        s["y"] = max(s["y"], err.max().item())
        s["bad"] += int(not (bool(torch.isfinite(y).all()) and bool((err <= tol).all())))
        captured["flash"].append((q, k, v, scale, q_start))
        return y

    orig_router = moe.router_weights

    def recorded_router(cfg_, p, x):
        w, idx = orig_router(cfg_, p, x)
        router_rows.append((x, p["router"], idx, w))
        return w, idx

    saved = (ops.fused_prologue, ops.w4a4_lowrank_matmul, ops.fused_w4a4_lrc,
             ops.flash_attention)
    ops.fused_prologue, ops.w4a4_lowrank_matmul = checked_prologue, checked_gemm
    ops.fused_w4a4_lrc, ops.flash_attention = checked_fused, checked_flash
    moe.router_weights = recorded_router
    reset_launches()
    try:
        cache = eng._fresh_cache()
        toks = torch.from_numpy(prompt[None, :]).to(device)
        logits, cache = eng._prefill(eng.params, {"tokens": toks}, cache)
        tok = logits[:, -1].argmax(-1).reshape(1, 1).to(torch.int32)
        logits2, cache = eng._decode(eng.params, tok, cache)
        torch.cuda.synchronize()
    finally:
        (ops.fused_prologue, ops.w4a4_lowrank_matmul, ops.fused_w4a4_lrc,
         ops.flash_attention) = saved
        moe.router_weights = orig_router
    counts = launches()
    expected = _ds_expected(cfg, eng.params, counts, 2)
    finite = bool(torch.isfinite(logits).all()) and bool(torch.isfinite(logits2).all())
    for key, s in sorted(sites.items(), key=str):
        print(f"  (b) {key[0]:<8} {str(key[1:]):<22} calls {s['calls']:<4} max|kernel - "
              f"plain| x·V {s['xv']:.3e} y {s['y']:.3e}; {s['bad']} outside the "
              f"standard" + (f"; {s['not_chained']} not bitwise the chained path"
                             if key[0] == "fused" else "")
              + (f"; {s['zero_rows']} all-zero rows, {s['zero_rows_bad']} calls with "
                 f"them not bitwise" if key[0] in ("fused", "gemm") else ""), flush=True)
    bad = sum(s["bad"] + s["not_chained"] + s["zero_rows_bad"] for s in sites.values())
    print(f"  (b) one prefill and one decode call: launches {counts}, want {expected}; "
          f"logits finite {finite}", flush=True)
    if bad or counts != expected or not finite:
        raise SystemExit("DeepSeek-V2: a kernel call of the checked prefill/decode "
                         "missed its standard, or the launches are not exact")
    # wkv_b expands the whole cache, whose rows past the offset are zeros
    wkv_b = [s for k, s in sites.items() if k[0] in ("fused", "gemm")
             and k[1:3] == (cfg.kv_lora_rank, cfg.n_heads * (cfg.qk_nope_dim
                                                           + cfg.v_head_dim))]
    if not wkv_b or not all(s["zero_rows"] for s in wkv_b):
        raise SystemExit("DeepSeek-V2: wkv_b's calls held no all-zero cache row")
    picked = torch.zeros(cfg.n_experts, dtype=torch.bool, device=device)
    for _, _, idx, _ in router_rows:
        picked[idx.reshape(-1)] = True
    unpicked = int((~picked).sum())
    print(f"  (b) every routed expert's wg/wu/wd held (all {cfg.n_experts} experts run "
          f"every token); {unpicked} of them were picked by no token of these calls",
          flush=True)
    if not unpicked:
        raise SystemExit("DeepSeek-V2: no held expert went unpicked")
    worst = {name: max([s[field] for k, s in sites.items() if k[0] == kind], default=0.0)
             for name, kind, field in (("fused_prologue", "prologue", "xv"),
                                       ("w4a4_lowrank_matmul", "gemm", "y"),
                                       ("fused_w4a4_lrc", "fused", "y"),
                                       ("flash_attention", "flash", "y"))}
    stats = {"sites": {f"{k[0]}:{k[1:]}": {kk: vv for kk, vv in s.items()}
                       for k, s in sites.items()},
             "unpicked_experts": unpicked, "launches": counts}
    return stats, worst, captured, router_rows


def _ds_flash(device, captured, flush):
    """(c) #7 at the served shapes with random bf16 inputs (Sq 12 at
    q_start 0; Sq 1 at each offset of DS_DECODE_OFFSETS; Skv 64, H = KH =
    128, D 192, Dv 128) within ``_flash_tolerance`` of its plain version,
    and the served calls' own inputs timed: kernel, plain, bound, SDPA."""
    import torch

    from repro_torch.bench.common import time_ms
    from repro_torch.kernels import flash_attn

    gen = torch.Generator(device=device).manual_seed(17)
    h, d, dv = 128, 192, 128
    scale = 1.0 / d**0.5
    worst = 0.0
    k = torch.randn((1, DS_MAX_SEQ, h, d), generator=gen, device=device).to(torch.bfloat16)
    v = torch.randn((1, DS_MAX_SEQ, h, dv), generator=gen, device=device).to(torch.bfloat16)
    cases = [(PROMPT_LEN, 0)] + [(1, off) for off in DS_DECODE_OFFSETS]
    for sq, q0 in cases:
        q = torch.randn((1, sq, h, d), generator=gen, device=device).to(torch.bfloat16)
        qs = torch.full((1,), q0, dtype=torch.int32, device=device)
        y = _uncounted(flash_attn.flash_attention, q, k, v, scale, True, qs)
        yp = _uncounted(flash_attn.flash_attention_plain, q, k, v, scale, True, qs)
        tol = _flash_tolerance(q, k, v, scale, yp, q0)
        err = (y.double() - yp.double()).abs()
        ok = bool(torch.isfinite(y).all()) and bool((err <= tol).all())
        worst = max(worst, err.max().item())
        if not ok:
            raise SystemExit(f"DeepSeek-V2: #7 at Sq {sq}, q_start {q0} outside "
                             f"_flash_tolerance (max err {err.max().item():.3e})")
    print(f"  (c) #7 at Sq {PROMPT_LEN} (q_start 0) and Sq 1 at q_start "
          f"{DS_DECODE_OFFSETS[0]}..{DS_DECODE_OFFSETS[-1]}, Skv {DS_MAX_SEQ}, H = KH = "
          f"{h}, D {d}, Dv {dv}, bf16: max |kernel - plain| {worst:.3e}, all within "
          f"_flash_tolerance", flush=True)
    timed = {}
    # layer 0's call of the prefill and of the decode
    firsts = [next(c for c in captured if c[0].shape[1] > 1),
              next(c for c in captured if c[0].shape[1] == 1)]
    for q, kk, vv, sc, qs in firsts:
        sq, q0 = q.shape[1], (0 if qs is None else int(qs.max()))
        label = "prefill" if sq > 1 else "decode"
        t_k = time_ms(lambda: _uncounted(flash_attn.flash_attention, q, kk, vv, sc, True, qs),
                      flush)
        t_p = time_ms(lambda: _uncounted(flash_attn.flash_attention_plain, q, kk, vv, sc,
                                         True, qs), flush)
        t_l = _sdpa_timer(q, kk, vv, q0, sc, flush)
        # q read and the output written once, and only the K/V rows at or
        # before the last query position; the products over the keys each
        # row attends (q0 + i + 1), as three TF32 passes
        b_ms, by, _ = _prefill_bound((1, sq, kk.shape[1], h, h, d, dv, q0, "bfloat16"),
                                     2 * d, 2 * dv)
        timed[label] = (t_k, t_p, b_ms, by, t_l)
        print(f"  (c) #7 {label} (Sq {sq}, q_start {q0}, Skv {kk.shape[1]}): kernel "
              f"{t_k * 1e3:.2f} us, plain {t_p * 1e3:.2f} us, bound {b_ms * 1e3:.3f} us "
              f"({by}), SDPA {t_l * 1e3:.2f} us", flush=True)
    return worst, timed


def _ds_site_times(cfg, captured, flush):
    """The served decode call's distinct W4A4 sites timed on their own
    inputs (M 1; wkv_b at M 64, the whole cache): #3 and #2 for each
    chained site, #1 for the fused one, beside their bounds and plain
    versions (L2 flushed)."""
    from repro_torch.bench.common import time_ms
    from repro_torch.kernels import fused_gemm, prologue, w4a4

    timed = {}
    for key, (x, v, wp, sw, u) in sorted(
            ((k, c) for k, c in captured.items() if k != "flash"), key=str):
        path, k, n, r = key
        m = x.shape[0]
        if m not in (1, DS_MAX_SEQ):
            continue  # the prefill's calls (M 12); the decode's are timed
        xb, fb = x.element_size(), 2
        if path == "fused":
            runs = {"fused_w4a4_lrc": (
                lambda: fused_gemm.fused_w4a4_lrc(x, v, wp, sw, u, 4, 0.9),
                lambda: fused_gemm.fused_w4a4_lrc_plain(x, v, wp, sw, u, 4, 0.9),
                _bound_ms(m, k, n, r, xb, fb))}
        else:
            xq, sx, xv = prologue.fused_prologue_plain(x, v, 4, 0.9)
            bounds = _chain_bounds(m, k, n, r, xb, fb)
            runs = {"fused_prologue": (lambda: prologue.fused_prologue(x, v, 4, 0.9),
                                       lambda: prologue.fused_prologue_plain(x, v, 4, 0.9),
                                       bounds["fused_prologue"]),
                    "w4a4_lowrank_matmul": (
                        lambda: w4a4.w4a4_lowrank_matmul(xq, sx, wp, sw, xv, u),
                        lambda: w4a4.w4a4_lowrank_matmul_plain(xq, sx, wp, sw, xv, u),
                        bounds["w4a4_lowrank_matmul"])}
        for name, (kern, plain, (b, by)) in runs.items():
            t_k = time_ms(lambda: _uncounted(kern), flush)
            t_p = time_ms(lambda: _uncounted(plain), flush)
            timed[(name, m, k, n, r)] = (t_k, t_p, b, by)
            print(f"    {name:<20} M {m:<3} K {k:<6} N {n:<6} R {r:<4} kernel "
                  f"{t_k * 1e3:9.2f} us  plain {t_p * 1e3:10.2f} us  bound "
                  f"{b * 1e3:8.3f} us ({by})", flush=True)
    return timed


def _ds_router(cfg, device, router_rows):
    """(d) The router's top-k indices on the card equal the plain CPU
    router's on the same bf16 rows, with the served router and with one
    whose expert columns come in equal pairs (every score tied with
    another: the lower index must come first, on both devices)."""
    import torch

    from repro_torch.models import moe

    rows = torch.cat([x.reshape(-1, x.shape[-1]) for x, _, _, _ in router_rows])
    router = router_rows[0][1]
    tied = router.clone()
    tied[:, 1::2] = tied[:, 0::2]
    out = {}
    for label, w in (("served", router), ("tied pairs", tied)):
        _, idx = moe.router_weights(cfg, {"router": w}, rows)
        _, idx_c = moe.router_weights(cfg, {"router": w.cpu()}, rows.cpu())
        same = torch.equal(idx.cpu(), idx_c)
        out[label] = same
        if label == "tied pairs":
            pairs = idx_c.reshape(idx_c.shape[0], -1)
            # in every tied pair that both made the top-k, the even index first
            order = all(int(a) < int(b) for row in pairs.tolist()
                        for a, b in zip(row, row[1:]) if a // 2 == b // 2)
            out["tie_order"] = order
            same = same and order
        print(f"  (d) router top-{cfg.moe_top_k} over {rows.shape[0]} bf16 rows, "
              f"{label}: card indices {'==' if out[label] else '!='} the CPU's"
              + (f"; tied pairs lower index first: {out['tie_order']}"
                 if label == "tied pairs" else ""), flush=True)
        if not same:
            raise SystemExit(f"DeepSeek-V2: the router's indices on the card differ from "
                             f"the CPU's ({label})")
    out["rows"] = int(rows.shape[0])
    return out


def _ds_streams(cfg, qparams, device, prompts, baseline):
    """(e) Each request served alone (a 1-request run of a SLOTS-slot
    engine) bitwise its co-tenant stream; then a crash mid-decode with a
    snapshot every 4 steps, restored on the card, every stream bitwise
    the uninterrupted run's and every rid terminal once in the journal."""
    import tempfile

    import torch

    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.faults import FaultInjector, FaultSpec, SimulatedCrash
    from repro_torch.serve.journal import JournalWriter, collate, read_journal

    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        eng = _ds_engine(cfg, qparams, device)
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS))
        rec = eng.run()[i]
        if rec.out_tokens != baseline[i]:
            raise SystemExit(f"DeepSeek-V2: rid {i} alone {rec.out_tokens} is not its "
                             f"co-tenant stream {baseline[i]}")
    alone_s = time.perf_counter() - t0
    print(f"  (e) each of the {len(prompts)} requests served alone: bitwise its "
          f"co-tenant stream ({alone_s:.1f} s)", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        jpath = Path(tmp) / "journal.wal"
        journal = JournalWriter(jpath, fsync=True)
        # rid 1's decode call of step 5, the step after the snapshot of step
        # 4: rid 0 has decoded in it (its journal is ahead of the snapshot:
        # re-prefilled, its tokens fed), rids 1-3 resume in place
        crash = FaultSpec(kind="process_crash", phase="decode", rid=1, at_call=4)
        eng = _ds_engine(cfg, qparams, device, journal=journal,
                         snapshot_dir=str(Path(tmp) / "snaps"), snapshot_every=4,
                         injector=FaultInjector([crash]))
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS))
        try:
            eng.run()
        except SimulatedCrash as e:
            print(f"  (e) {e} at step {eng.counters['steps']}", flush=True)
        else:
            raise SystemExit("DeepSeek-V2: the crash point was never hit")
        finally:
            journal.close()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        eng2 = ServeEngine.restore(cfg, qparams, jpath, snapshot_dir=str(Path(tmp) / "snaps"),
                                   max_retries=MAX_RETRIES, device=device)
        restore_s = time.perf_counter() - t1
        marker = collate(read_journal(jpath).records).recovers[-1]
        done = eng2.run()
        eng2.journal.close()
        col = collate(read_journal(jpath).records)
    bad = [rid for rid in range(len(prompts))
           if done[rid].out_tokens != baseline[rid] or col.tokens.get(rid) != baseline[rid]]
    if sorted(col.terminals) != list(range(len(prompts))) or bad:
        raise SystemExit(f"DeepSeek-V2: restored streams {bad} differ from the "
                         f"uninterrupted run, or terminals {sorted(col.terminals)}")
    print(f"  (e) restored from snapshot step {marker['snapshot_step']} in {restore_s:.3f} "
          f"s (resumed {marker['resumed']}, requeued {marker['requeued']}): every "
          f"rid terminal once, every stream bitwise the uninterrupted run's", flush=True)
    return {"alone_s": alone_s, "restore_s": restore_s,
            "snapshot_step": marker["snapshot_step"], "resumed": marker["resumed"],
            "requeued": marker["requeued"]}


def _tree_to(tree, device):
    """A param tree (dicts, lists, tensors, QLinears) moved to ``device``."""
    import dataclasses

    from repro_torch.quant.qlinear import QLinear

    if isinstance(tree, QLinear):
        return dataclasses.replace(tree, **{
            f: None if getattr(tree, f) is None else getattr(tree, f).to(device)
            for f in ("qweight", "w_scale", "u", "v")})
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def _ds_calibrate(device):
    """(f) ``_quantize_moe`` (GPTQ + LRC, per-expert statistics, rank 10 %,
    clip 0.9) on the reduced DeepSeek-V2 on the card, MLA's attention
    through #7; one site of each weight shape solved again on this
    machine's CPU in f64 from the card's statistics (codes and scales
    bitwise, U·Vᵀ and the losses within CPU_REL, as phase 9 holds the dense
    walker); the same walk on the CPU, the two models' logits correlated
    at least 0.9 (ROADMAP Queue 3's standard for walks on two devices)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.lrc import lrc_solve
    from repro_torch.core.quantizers import QuantSpec
    from repro_torch.data.loader import calib_sequences
    from repro_torch.models import model
    from repro_torch.models.config import reduced
    from repro_torch.quant import calibrate
    from repro_torch.quant.policy import QuantPolicy

    policy = QuantPolicy(**CALIB_POLICY)
    cfg = reduced(get_config("deepseek-v2-236b"))
    params = model.init_params(cfg, seed=0, device="cpu")
    tokens = calib_sequences(cfg, n_seq=DS_CALIB_SEQS, seq_len=DS_CALIB_LEN, device="cpu")
    sites, solves = {}, []
    orig_solve, orig_lrc = calibrate.solve_site, calibrate.lrc_solve

    def solve(w, st, pol, pre_rot=False, name=None):
        sites.setdefault(tuple(w.shape), (w, st, len(solves)))
        return orig_solve(w, st, pol, pre_rot, name)

    def solve_lrc(*a, **kw):
        res = orig_lrc(*a, **kw)
        solves.append(res)
        return res

    card_params = _tree_to(params, device)
    calibrate.solve_site, calibrate.lrc_solve = solve, solve_lrc
    reset_launches()
    t0 = time.perf_counter()
    try:
        q_card = calibrate.quantize_model(cfg, card_params, tokens.to(device), policy)
        torch.cuda.synchronize()
    finally:
        calibrate.solve_site, calibrate.lrc_solve = orig_solve, orig_lrc
    card_s = time.perf_counter() - t0
    counts = launches()
    want = {k: (cfg.n_layers if k == "flash_attention" else 0) for k in counts}
    if counts != want:
        raise SystemExit(f"DeepSeek-V2 walk: launches {counts}, want {cfg.n_layers} #7 "
                         f"and nothing else")
    n_sites = len(solves)
    out = {"card_s": card_s, "lrc_solves": n_sites}
    for shape, (w, st, i) in sorted(sites.items()):
        ref = solves[i]
        res = lrc_solve(w.to(torch.float64).T.cpu(), st.to("cpu"), QuantSpec(bits=4),
                        k=policy.rank(*shape), iters=policy.lrc_iters,
                        quant_method=policy.quant_method)
        codes = (torch.equal(res.qweight, ref.qweight.cpu())
                 and torch.equal(res.scales, ref.scales.cpu()))
        u, v = ref.u.cpu().double(), ref.v.cpu().double()
        uv_g = u @ v.T
        tol = CPU_REL * uv_g.abs().max() + 2 * 2.0 ** -24 * (u.abs() @ v.abs().T)
        uv_err = (res.u.double() @ res.v.double().T - uv_g).abs()
        losses = max(abs(a - b) / abs(b) for a, b in zip(res.losses + [res.oracle_loss],
                                                         ref.losses + [ref.oracle_loss]))
        ok = codes and bool((uv_err <= tol).all()) and losses <= CPU_REL
        out[str(shape)] = {"codes_bitwise": codes, "uv_max_abs_diff": uv_err.max().item(),
                           "loss_max_rel_diff": losses}
        print(f"  (f) site {shape}: card vs CPU codes+scales "
              f"{'bitwise' if codes else 'DIFFER'}, U·Vᵀ max |diff| "
              f"{uv_err.max().item():.3e}, losses max rel {losses:.3e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"DeepSeek-V2 walk: site {shape} solved on the card "
                             f"disagrees with the CPU")
    q_cpu = calibrate.quantize_model(cfg, params, tokens, policy)
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 32)))
    q_back = _tree_to(q_card, "cpu")
    a = model.forward(cfg, q_back, {"tokens": toks}).flatten()
    b = model.forward(cfg, q_cpu, {"tokens": toks}).flatten()
    corr = torch.corrcoef(torch.stack([a, b]))[0, 1].item()
    out["logits_correlation"] = corr
    print(f"  (f) reduced DeepSeek-V2 walked on the card in {card_s:.2f} s ({n_sites} LRC "
          f"solves, {cfg.n_layers} #7 launches); its logits against the CPU walk's: "
          f"correlation {corr:.4f}", flush=True)
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()) or corr < 0.9:
        raise SystemExit("DeepSeek-V2 walk: the card's and the CPU's walks disagree")
    return out


def phase_deepseek(device):
    """Phase 17 (see the module docstring).  Returns (stats, worst errors,
    site times, #7 times, launches)."""
    import torch

    from repro_torch.bench.common import flush_buffer

    t0 = time.perf_counter()
    cfg, qparams, out = _ds_build(device)
    prompts = serve_prompts(cfg)
    print(f"  (a) served in slots mode: {SLOTS} slots, max_seq {DS_MAX_SEQ}, "
          f"{N_REQUESTS} requests of {PROMPT_LEN} tokens x {NEW_TOKENS} new, greedy",
          flush=True)
    counts, out["serve"] = _ds_serve(cfg, qparams, device, prompts)
    eng = _ds_engine(cfg, qparams, device)
    out["checked"], worst, captured, router_rows = _ds_checked(cfg, eng, device, prompts[0])
    flush = flush_buffer(device)
    flash_worst, flash_timed = _ds_flash(device, captured["flash"], flush)
    worst["flash_attention"] = max(worst["flash_attention"], flash_worst)
    site_timed = _ds_site_times(cfg, captured, flush)
    out["router"] = _ds_router(cfg, device, router_rows)
    del eng, captured, router_rows
    out["absorb"] = _ds_absorb(cfg, qparams, device, prompts[0])
    out["streams"] = _ds_streams(cfg, qparams, device, prompts,
                                 out["serve"]["streams"])
    del qparams
    gc.collect()
    torch.cuda.empty_cache()
    out["calibration"] = _ds_calibrate(device)
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 17: {out['seconds']:.1f} s", flush=True)
    return out, worst, site_timed, flash_timed, counts


def add_deepseek_entries(kernels, worst, site_timed, flash_timed, counts):
    """The ``deepseek`` sub-entries of #1, #2, #3 and #7: phase 17's served
    decode call's sites (one each, L2 flushed) and #7's served calls, the
    launches of phase 17(a)'s serving (which the entries' own
    ``launches`` then include) and the largest |kernel - plain| of phase
    17(b) and (c)."""
    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    at = ("DeepSeek-V2 at full width ({} layers), one slot decode call's sites on their "
          "served inputs, L2 flushed; launches from phase 17(a)'s serving")
    for entry in kernels:
        name = entry["name"]
        if name not in worst:
            continue
        if name == "flash_attention":
            t_k, t_p, b, by, t_l = flash_timed["decode"]
            sub = {"ms": t_k, "plain_ms": t_p, "bound_ms": b, "bound_by": by,
                   "library_ms": t_l,
                   "shapes": {label: dict(zip(keys + ("library_ms",), v))
                              for label, v in flash_timed.items()},
                   "at": ("DeepSeek-V2's MLA decode call: B 1, Sq 1, Skv 64, H = KH = 128, "
                          "D 192, Dv 128, bf16, q_start at the served offset, L2 flushed; "
                          "library: SDPA with a mask on an expanded copy; launches from "
                          "phase 17(a)'s serving")}
        else:
            rows = {k: v for k, v in site_timed.items() if k[0] == name}
            sub = {"ms": sum(v[0] for v in rows.values()),
                   "plain_ms": sum(v[1] for v in rows.values()),
                   "bound_ms": sum(v[2] for v in rows.values()),
                   "bound_by": ("bytes" if all(v[3] == "bytes" for v in rows.values())
                                else "operations"),
                   "library_ms": None,
                   "sites": {f"M{k[1]}_K{k[2]}_N{k[3]}_R{k[4]}": dict(zip(keys, v))
                             for k, v in rows.items()},
                   "at": at.format(DEEPSEEK_LAYERS) + "; ms = the sum over the distinct "
                         "sites"}
        sub["launches"] = counts[name]
        sub["max_abs_err"] = worst[name]
        entry["deepseek"] = sub
        entry["launches"] += counts[name]
        entry["max_abs_err"] = max(entry["max_abs_err"], worst[name])


# ---------------------------------------------------------------------------
# phase 18: Phi-4-mini at full width, the dense contiguous cache, the
# quantize launcher, MoE training (mla_absorb runs in phase 17(g))
# ---------------------------------------------------------------------------

# Phi-4-mini's depth served here: 4 of its 32 layers, at full width (24/8
# heads of 128, d_ff 8,192, vocab 200,064); RTN+SVD at Phi-3's ~6.5 s a
# layer keeps the phase inside the script's time
PHI4_LAYERS = 4
# (b) the contiguous cache: B 1, max_seq 64, f32 as the engine's pool; a
# decode call is also timed at CONTIG_LONG_SEQ (a step writes its own rows
# in place, so its time must not grow with max_seq)
CONTIG_MAX_SEQ = 64
CONTIG_LONG_SEQ = 4096
# (b) the contiguous path against the paged engine for the same request,
# teacher-forced with the engine's tokens (see _contiguous).  f32 weights:
# every step's max |contiguous - engine| over the engine's max |logit|
# stays within this (the CPU test of the same comparison: 1e-5 absolute,
# tests/test_torch_dense_cache.py); the two differ only in #7 against #6's
# f32 summation order
CONTIG_F32_REL = 1e-5
# the W4A4 model: once an attention output differs in one bf16 element
# (#7 and #6 round some elements apart), 4-bit activation codes turn that
# into code flips downstream, so every later step's logits correlate only
# this well with the engine's (a floor; the gates that see a fault are the
# bitwise ones and the held calls)
CONTIG_MIN_CORRELATION = 0.9
# (d) MoE training: steps of the reduced V3 (CE + MTP) and V2 on the card
MOE_TRAIN_STEPS = 8
# (g) of phase 17: the decode calls mla_absorb is held over, and its MLA
# attention outputs against the naive path's on the same inputs and the
# same wkv_b (its effective weight; bf16 in the naive path's expansion):
# the naive path rounds the expanded K/V and #7's output to bf16, the
# absorbed one computes in f32 and rounds its output once, a few bf16 ulps
# (2^-8 relative each) of the largest output at most; a wrong mask or
# weight moves them by their own size
DS_ABSORB_DECODES = 4
ABSORB_MIN_CORRELATION = 0.999
ABSORB_MAX_REL = 2.0 ** -5


def _held_calls():
    """A context that holds every #3, #2, #6 and #7 call inside it to its
    plain version on the same inputs (the plain calls uncounted): #3's
    codes and scales bitwise and x·V within ``xv_tolerance``, #2 within
    ``gemm_tolerance``, #6 within ``flash_attn.paged_attention_bound``, #7
    within ``_flash_tolerance``.  Yields the per-kernel stats (calls,
    worst |kernel - plain|, calls outside the standard)."""
    import contextlib

    import torch

    from repro_torch.bench.common import gemm_tolerance, xv_tolerance
    from repro_torch.kernels import flash_attn, ops, prologue, w4a4

    names = ("fused_prologue", "w4a4_lowrank_matmul", "paged_flash_attention",
             "flash_attention")
    stats = {n: {"calls": 0, "worst": 0.0, "bad": 0} for n in names}

    def note(name, err, ok):
        s = stats[name]
        s["calls"] += 1
        s["worst"] = max(s["worst"], err)
        s["bad"] += int(not ok)

    def held_prologue(x, v, bits=4, clip_ratio=1.0, rotate=False, group=None):
        xq, sx, xv = prologue.fused_prologue(x, v, bits, clip_ratio, rotate, group)
        xq_p, sx_p, xv_p = _uncounted(prologue.fused_prologue_plain, x, v, bits,
                                      clip_ratio, rotate, group)
        ok, err = torch.equal(xq, xq_p) and torch.equal(sx, sx_p), 0.0
        if v is not None:
            e = (xv - xv_p).abs()
            err = e.max().item()
            ok = ok and bool((e <= xv_tolerance(x, v, x.shape[1], xv_p)).all())
        note("fused_prologue", err, ok)
        return xq, sx, xv

    def held_gemm(xq, sx, wp, sw, xv=None, u=None, group=None):
        y = w4a4.w4a4_lowrank_matmul(xq, sx, wp, sw, xv, u, group)
        y_p = _uncounted(w4a4.w4a4_lowrank_matmul_plain, xq, sx, wp, sw, xv, u, group)
        e = (y - y_p).abs()
        r = 0 if xv is None else xv.shape[1]
        note("w4a4_lowrank_matmul", e.max().item(),
             bool((e <= gemm_tolerance(xv, u, r, y_p)).all()))
        return y

    def held_paged(q, kp, vp, bt, lengths, scale):
        y = flash_attn.paged_flash_attention(q, kp, vp, bt, lengths, scale)
        y_p = _uncounted(flash_attn.paged_flash_attention_plain, q, kp, vp, bt,
                         lengths, scale)
        dense = [p[bt.long()].reshape(q.shape[0], -1, *p.shape[2:]) for p in (kp, vp)]
        tol = flash_attn.paged_attention_bound(q, *dense, lengths, scale, kp.shape[1], y_p)
        e = (y.double() - y_p.double()).abs()
        note("paged_flash_attention", e.max().item(), bool((e <= tol).all()))
        return y

    def held_flash(q, k, v, scale, causal=True, q_start=None):
        y = flash_attn.flash_attention(q, k, v, scale, causal, q_start)
        y_p = _uncounted(flash_attn.flash_attention_plain, q, k, v, scale, causal, q_start)
        q0 = 0 if q_start is None else int(q_start.max())
        e = (y.double() - y_p.double()).abs()
        note("flash_attention", e.max().item(),
             bool(torch.isfinite(y).all())
             and bool((e <= _flash_tolerance(q, k, v, scale, y_p, q0)).all()))
        return y

    @contextlib.contextmanager
    def held():
        saved = (ops.fused_prologue, ops.w4a4_lowrank_matmul, ops.paged_flash_attention,
                 ops.flash_attention)
        (ops.fused_prologue, ops.w4a4_lowrank_matmul, ops.paged_flash_attention,
         ops.flash_attention) = held_prologue, held_gemm, held_paged, held_flash
        try:
            yield stats
        finally:
            (ops.fused_prologue, ops.w4a4_lowrank_matmul, ops.paged_flash_attention,
             ops.flash_attention) = saved

    return held()


def _held_gate(stats, want, what):
    """Print ``stats`` of :func:`_held_calls` and fail unless every kernel
    made ``want[name]`` calls, each within its standard."""
    for name, s in stats.items():
        print(f"  {what}: {name:<22} calls {s['calls']:<4} (want {want.get(name, 0)}) "
              f"max |kernel - plain| {s['worst']:.3e}; {s['bad']} outside the standard",
              flush=True)
    if any(s["bad"] for s in stats.values()) or any(
            s["calls"] != want.get(n, 0) for n, s in stats.items()):
        raise SystemExit(f"phase 18 {what}: a kernel call missed its standard, or the "
                         f"calls are not the path's")


def _phi4_engine(cfg, params, device, slots=SLOTS, ctx=None):
    from repro_torch.serve.engine import ServeEngine

    return ServeEngine(cfg, params, batch_slots=slots, max_seq=CONTIG_MAX_SEQ,
                       page_size=PAGE, prefill_chunk=CHUNK, device=device, ctx=ctx)


def _phi4_held(cfg, qparams, device):
    """(a) SLOTS prompts prefilled (one chunk each) and one decode step of
    the served Phi-4-mini, every kernel call held to its plain version."""
    import torch

    from repro_torch.serve.engine import Request

    eng = _phi4_engine(cfg, qparams, device)
    for i, p in enumerate(serve_prompts(cfg)[:SLOTS]):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS))
    with _held_calls() as stats:
        eng._admit()
        eng._step()
        torch.cuda.synchronize()
    sites, n = 7 * cfg.n_layers, cfg.n_layers
    _held_gate(stats, {"fused_prologue": sites * (SLOTS + 1),
                       "w4a4_lowrank_matmul": sites * (SLOTS + 1),
                       "flash_attention": n * SLOTS, "paged_flash_attention": n},
               f"(a) {SLOTS} prefill chunks and one decode step")
    return {k: dict(v) for k, v in stats.items()}


def _attention_log():
    """A context that records (q, out) of every ``ops.flash_attention``
    and ``ops.paged_flash_attention`` call inside it, in call order, as
    (rows, heads · width) f32 on the host (exact for bf16; B 1)."""
    import contextlib

    from repro_torch.kernels import ops

    calls = []

    def logged(fn):
        def call(q, *args, **kw):
            out = fn(q, *args, **kw)
            calls.append(tuple(t.detach().float().reshape(-1, t.shape[-2] * t.shape[-1]).cpu()
                               for t in (q, out)))
            return out
        return call

    @contextlib.contextmanager
    def log():
        saved = ops.flash_attention, ops.paged_flash_attention
        ops.flash_attention, ops.paged_flash_attention = map(logged, saved)
        try:
            yield calls
        finally:
            ops.flash_attention, ops.paged_flash_attention = saved

    return log()


def _engine_stream(cfg, params, device, prompt, ctx=None):
    """One request through the paged engine (one slot) on ``ctx``'s
    attention route, every kernel call held: (greedy stream, each model
    call's last logits row, the attention calls' log, the held stats)."""
    from repro_torch.serve.engine import Request

    eng = _phi4_engine(cfg, params, device, slots=1, ctx=ctx)
    rows, inner = [], eng._paged

    def kept(*a, **kw):
        out = inner(*a, **kw)
        rows.append(out[0][:, -1].float())
        return out

    eng._paged = kept
    eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=NEW_TOKENS))
    with _held_calls() as held, _attention_log() as attn:
        stream = list(eng.run()[0].out_tokens)
    if len(rows) != NEW_TOKENS:
        raise SystemExit(f"(b): the engine made {len(rows)} model calls, want {NEW_TOKENS}")
    return stream, rows, attn, held


def _contiguous_run(cfg, params, device, prompt, feed=None, ctx=None,
                    max_seq=CONTIG_MAX_SEQ):
    """NEW_TOKENS calls of the contiguous path: ``model.init_cache`` (f32,
    B 1), ``prefill``, then ``decode_step`` fed ``feed`` (None: its own
    greedy tokens).  Returns (each call's last logits row, greedy tokens,
    seconds per call, the final offset)."""
    import torch

    from repro_torch.models import model

    cache = model.init_cache(cfg, 1, max_seq, dtype=torch.float32, device=device)
    toks = torch.from_numpy(prompt[None, :]).to(device)
    rows, got, times = [], [], []
    for i in range(NEW_TOKENS):
        t0 = time.perf_counter()
        if i == 0:
            logits, cache = model.prefill(cfg, params, {"tokens": toks}, cache, ctx=ctx)
        else:
            tok = feed[i - 1] if feed is not None else got[-1]
            tok = torch.tensor([[tok]], dtype=torch.int32, device=device)
            logits, cache = model.decode_step(cfg, params, tok, cache, ctx=ctx)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        rows.append(logits[:, -1].float())
        got.append(int(logits[0, -1].argmax()))
    return rows, got, times, int(cache["offset"])


def _first_difference(mine, theirs, n_layers):
    """Two runs' attention logs walked in call order, each call's rows
    that both hold (the engine pads a prefill chunk after the prompt): None
    when every q and output is bitwise equal, else (step, layer, q bitwise
    equal there, outputs that differ of how many, the largest difference)
    at the first call whose q or output differs."""
    import torch

    if len(mine) != len(theirs):
        raise SystemExit(f"(b): {len(mine)} attention calls against {len(theirs)}")
    for i, ((qa, oa), (qb, ob)) in enumerate(zip(mine, theirs)):
        rows = min(qa.shape[0], qb.shape[0])
        qa, oa, qb, ob = qa[:rows], oa[:rows], qb[:rows], ob[:rows]
        same_q = bool(torch.equal(qa, qb))
        if not same_q or not torch.equal(oa, ob):
            d = (oa - ob).abs()
            return (i // n_layers, i % n_layers, same_q, int((d > 0).sum()), oa.numel(),
                    d.max().item())
    return None


def _correlations(rows, ref):
    import torch

    return [torch.corrcoef(torch.cat([a, b]))[0, 1].item() for a, b in zip(rows, ref)]


def _contiguous(cfg, qparams, device):
    """(b) One request through the contiguous entry points
    (``model.init_cache`` f32, B 1, max_seq 64; ``prefill``; ``decode_step``
    per token) on the kernel route, #7 with q_start 0 then at the offset,
    teacher-forced with the paged engine's greedy stream for the same
    prompt, the counted main path: every kernel call of all NEW_TOKENS
    calls held to its plain version (the engine's too), launches exact.
    Its logits against the engine's at every step, with three witnesses
    that locate any difference: (1) both paths' attention calls walked in
    order: every q bitwise equal up to the first attention output that
    differs, which is then #7 against #6 on equal inputs (the cache,
    positions and offsets feed both alike); (2) the gather route in both
    (no #6, no #7) on the W4A4 model: logits bitwise at every step; (3) f32
    weights (no 4-bit codes to amplify a rounding difference; the
    projections are cuBLAS GEMMs, whose sums depend on M, so the engine's
    16-row prefill chunk and the 12-row prompt are not bitwise): every step
    within CONTIG_F32_REL.  Every W4A4 step's correlation at least
    CONTIG_MIN_CORRELATION.  Then the path's own greedy stream, unheld,
    timed at max_seq 64 and CONTIG_LONG_SEQ."""
    import dataclasses

    import torch

    from repro_torch.kernels.context import KernelContext
    from repro_torch.models import model
    from repro_torch.quant.qlinear import retag_qlinear_impl

    prompt = serve_prompts(cfg)[0]
    params = retag_qlinear_impl(qparams, "auto")
    sites, n = 7 * cfg.n_layers, cfg.n_layers
    calls = NEW_TOKENS
    stream, paged, paged_attn, paged_held = _engine_stream(cfg, qparams, device, prompt)
    reset_launches()
    with _held_calls() as held, _attention_log() as attn:
        forced, _, _, offset = _contiguous_run(cfg, params, device, prompt, stream)
    counts = launches()
    _held_gate(paged_held, {"fused_prologue": sites * calls,
                            "w4a4_lowrank_matmul": sites * calls, "flash_attention": n,
                            "paged_flash_attention": n * (calls - 1)},
               f"(b) the engine's {calls} calls")
    _held_gate(held, {"fused_prologue": sites * calls, "w4a4_lowrank_matmul": sites * calls,
                      "flash_attention": n * calls},
               f"(b) the contiguous path's {calls} calls")
    want = {k: 0 for k in counts}
    want.update(fused_prologue=sites * calls, w4a4_lowrank_matmul=sites * calls,
                flash_attention=n * calls)
    print(f"  (b) contiguous cache, {calls} calls (1 prefill, {calls - 1} decode), offset "
          f"{offset}: launches {counts}; want {want}", flush=True)
    if counts != want or offset != len(prompt) + calls - 1:
        raise SystemExit("(b): the contiguous path's launches are not 7 per layer of #3 "
                         "and #2 and one #7 per layer per call, or the offset is wrong")
    if not all(bool(torch.isfinite(r).all()) for r in forced + paged):
        raise SystemExit("(b): non-finite logits")
    corrs = _correlations(forced, paged)
    diffs = [(a - b).abs().max().item() for a, b in zip(forced, paged)]
    bitwise = [bool(torch.equal(a, b)) for a, b in zip(forced, paged)]
    first = _first_difference(attn, paged_attn, n)
    if first is None:
        where = "no attention output differs"
    else:
        where = (f"the first attention output that differs is step {first[0]} layer "
                 f"{first[1]} ({'#7' if first[0] == 0 else '#7 against #6'}); q bitwise "
                 f"equal up to it: {first[2]}; {first[3]} of {first[4]} outputs differ, "
                 f"by at most {first[5]:.3e}")
    print(f"  (b) W4A4 logits against the engine's, teacher-forced: bitwise at steps "
          f"{[i for i, x in enumerate(bitwise) if x]}; correlation every step "
          + " ".join(f"{c:.4f}" for c in corrs)
          + f" (floor {CONTIG_MIN_CORRELATION}); max |diff| {max(diffs):.4e}; {where}",
          flush=True)

    # (2) the gather route in both: the contiguous cache, offsets and masks
    # without either attention kernel
    gather = KernelContext(attention="gather")
    g_stream, g_paged, _, _ = _engine_stream(cfg, qparams, device, prompt, gather)
    g_forced = _contiguous_run(cfg, params, device, prompt, g_stream, gather)[0]
    g_bitwise = [bool(torch.equal(a, b)) for a, b in zip(g_forced, g_paged)]
    g_diff = max((a - b).abs().max().item() for a, b in zip(g_forced, g_paged))
    print(f"  (b) witness, gather route in both (W4A4): logits bitwise at "
          f"{sum(g_bitwise)}/{calls} steps, max |diff| {g_diff:.4e}", flush=True)

    # (3) f32 weights: #7 against #6 with no 4-bit codes after them
    fcfg = dataclasses.replace(cfg, dtype="float32")
    fparams = model.init_params(fcfg, seed=0, device=device)
    f_stream, f_paged, _, _ = _engine_stream(fcfg, fparams, device, prompt)
    f_forced = _contiguous_run(fcfg, fparams, device, prompt, f_stream)[0]
    f_rel = [(a - b).abs().max().item() / b.abs().max().item()
             for a, b in zip(f_forced, f_paged)]
    f_own = _contiguous_run(fcfg, fparams, device, prompt)[1]
    print(f"  (b) witness, f32 weights: max |diff| / max |logit| every step "
          + " ".join(f"{r:.2e}" for r in f_rel)
          + f" (limit {CONTIG_F32_REL}); greedy streams agree on "
          f"{sum(int(x == y) for x, y in zip(f_own, f_stream))}/{calls} tokens", flush=True)
    del fparams
    gc.collect()
    torch.cuda.empty_cache()

    _, own, times, _ = _contiguous_run(cfg, params, device, prompt)
    long_times = _contiguous_run(cfg, params, device, prompt, max_seq=CONTIG_LONG_SEQ)[2]
    agree = sum(int(x == y) for x, y in zip(own, stream))
    first_diff = next((i for i, (x, y) in enumerate(zip(own, stream)) if x != y), None)
    decode_ms = statistics.median(times[1:]) * 1e3
    long_ms = statistics.median(long_times[1:]) * 1e3
    print(f"  (b) the contiguous greedy stream agrees with the engine's on {agree}/{calls} "
          f"tokens (first difference at {first_diff}); prefill {times[0] * 1e3:.2f} ms, "
          f"decode call {decode_ms:.2f} ms (median) at max_seq {CONTIG_MAX_SEQ}, "
          f"{long_ms:.2f} ms at {CONTIG_LONG_SEQ}", flush=True)
    faults = []
    if not bitwise[0]:
        faults.append("the prefill's logits are not bitwise the engine's")
    if min(corrs) < CONTIG_MIN_CORRELATION:
        faults.append(f"a step's correlation is below {CONTIG_MIN_CORRELATION}")
    if first is not None and not first[2]:
        faults.append("an attention call's q differs before any attention output does")
    if first is not None and not all(bitwise[:first[0]]):
        faults.append("logits differ before any attention output does")
    if not all(g_bitwise):
        faults.append("the gather route's logits are not bitwise the engine's")
    if max(f_rel) > CONTIG_F32_REL:
        faults.append(f"an f32 step is off by more than {CONTIG_F32_REL} of the logits")
    if faults:
        raise SystemExit("(b): " + "; ".join(faults))
    return {"launches": counts, "held": {k: dict(v) for k, v in held.items()},
            "correlations": corrs, "max_abs_diff": max(diffs),
            "bitwise_steps": sum(bitwise), "first_attention_difference": first,
            "gather_bitwise_steps": sum(g_bitwise), "f32_rel": f_rel,
            "greedy_agreement": agree, "first_difference": first_diff,
            "prefill_ms": times[0] * 1e3, "decode_call_ms": decode_ms,
            "decode_call_ms_long": long_ms}


def _tensor_leaves(tree, path=()):
    """(path, tensor or None) of every array of a param tree, a QLinear's
    four arrays included."""
    from repro_torch.quant.qlinear import QLinear

    if isinstance(tree, QLinear):
        return [(path + (f,), getattr(tree, f)) for f in ("qweight", "w_scale", "u", "v")]
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _tensor_leaves(v, path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _tensor_leaves(v, path + (str(i),))]
    return [(path, tree)]


def _launcher(device, workdir):
    """(c) ``launch.quantize`` (GPTQ + LRC, rotation, its default 24 x 96
    calibration tokens) on SmolLM-135M at full width from a checkpoint this
    phase writes (random weights, seed 0); the walk's launches exact (#7
    once per layer); its output loaded through
    ``shell.quantized_param_shapes`` bitwise, leaf by leaf; both trees
    retagged ``"auto"`` and served on phase 4's traffic, the loaded model's
    streams bitwise the in-memory model's and every QLinear call through
    #1."""
    import torch

    from repro_torch.checkpoint.ckpt import load_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.launch import quantize as quantize_cli
    from repro_torch.models import model
    from repro_torch.quant.qlinear import retag_qlinear_impl
    from repro_torch.quant.shell import quantized_param_shapes
    from repro_torch.serve.engine import Request, RequestState

    params = model.init_params(get_config("smollm-135m"), seed=0, device=device)
    src = save_checkpoint(workdir / "model", 0, params)
    del params
    argv = ["--arch", "smollm-135m", "--full", "--ckpt", src, "--out",
            str(workdir / "quantized"), "--device", str(device)]
    print(f"  (c) python -m repro_torch.launch.quantize {' '.join(argv)}", flush=True)
    reset_launches()
    t0 = time.perf_counter()
    cfg, policy, qparams, path = quantize_cli.quantize(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    walk = launches()
    want = {k: (cfg.n_layers if k == "flash_attention" else 0) for k in walk}
    t1 = time.perf_counter()
    back = load_checkpoint(path, quantized_param_shapes(cfg, policy, rotated=True),
                           device=device)
    load_s = time.perf_counter() - t1
    mine, theirs = _tensor_leaves(qparams), _tensor_leaves(back)
    same = [a[0] == b[0] and ((a[1] is None and b[1] is None) or (
        a[1] is not None and b[1] is not None and a[1].dtype == b[1].dtype
        and torch.equal(a[1], b[1]))) for a, b in zip(mine, theirs)]
    n_q = sum(1 for p, _ in mine if p[-1] == "qweight")
    print(f"  (c) {cfg.name} quantized in {secs:.1f} s (walk launches {walk}; want "
          f"{cfg.n_layers} #7 and nothing else); loaded back through the shell in "
          f"{load_s:.2f} s: {sum(same)}/{len(mine)} leaves bitwise ({n_q} QLinears)",
          flush=True)
    if walk != want or len(mine) != len(theirs) or not all(same):
        raise SystemExit("(c): the launcher's walk launched other kernels, or its "
                         "checkpoint does not load back bitwise")
    streams, counts = {}, {}
    for label, tree in (("in-memory", qparams), ("loaded", back)):
        served = retag_qlinear_impl(tree, "auto")
        eng = _phi4_engine(cfg, served, device)
        for i, p in enumerate(serve_prompts(cfg)):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS))
        reset_launches()
        done = eng.run()
        torch.cuda.synchronize()
        counts[label] = launches()
        if any(r.status is not RequestState.FINISHED for r in done.values()):
            raise SystemExit(f"(c): the {label} model's requests did not finish")
        streams[label] = {rid: list(r.out_tokens) for rid, r in done.items()}
        calls = eng.counters["decode_calls"] + eng.counters["prefill_calls"]
        health = eng.health()
        expected = served_launches(cfg, health, eng.counters["decode_calls"],
                                   eng.counters["prefill_calls"], ["fused_w4a4_lrc"],
                                   counts[label])
        print(f"  (c) served the {label} model: {calls} model calls, launches "
              f"{counts[label]}", flush=True)
        if counts[label] != expected:
            raise SystemExit(f"(c): the {label} model's QLinears did not all go "
                             f"through #1, or its attention not through #6/#7")
    bitwise = streams["loaded"] == streams["in-memory"]
    print(f"  (c) the loaded model's {N_REQUESTS} streams bitwise the in-memory "
          f"model's: {bitwise}", flush=True)
    if not bitwise:
        raise SystemExit("(c): the loaded checkpoint serves other streams")
    return {"seconds": secs, "load_s": load_s, "leaves": len(mine), "qlinears": n_q,
            "walk_launches": walk, "serve_launches": counts["loaded"],
            "serve_launches_in_memory": counts["in-memory"]}


def _moe_train(device):
    """(d) The reduced DeepSeek-V3 (CE + MTP) and -V2: one train step on
    the card against the CPU's (phase 16(a)'s standard), then
    MOE_TRAIN_STEPS steps of ``train`` on the card: the loss finite and
    falling, no kernel launched."""
    import math

    from repro_torch.configs import get_config
    from repro_torch.models.config import reduced
    from repro_torch.train.trainer import train

    out = {}
    for arch in ("deepseek-v3-671b", "deepseek-v2-236b"):
        cfg = reduced(get_config(arch))
        step = _step_card_vs_cpu(device, cfg, f"(d) {arch}")
        reset_launches()
        t0 = time.perf_counter()
        _, hist, wd = train(cfg, steps=MOE_TRAIN_STEPS, global_batch=8, seq_len=64,
                            lr=1e-2, device=device, log=lambda s: None)
        secs = time.perf_counter() - t0
        n = sum(launches().values())
        falling = hist[-1] < hist[0]
        print(f"  (d) {arch} (mtp_depth {cfg.mtp_depth}) trained {len(hist)} steps on the "
              f"card: loss {hist[0]:.4f} -> {hist[-1]:.4f}, median step "
              f"{wd.p50 * 1e3:.1f} ms, {n} kernel launches", flush=True)
        if n or not falling or not all(math.isfinite(x) for x in hist):
            raise SystemExit(f"(d): {arch}'s training launched a kernel, or its loss "
                             f"is not finite and falling")
        out[arch] = {"step": step, "losses": hist, "seconds": secs,
                     "median_step_ms": wd.p50 * 1e3}
    return out


def phase_18(device):
    """Phase 18 (see the module docstring).  Returns (summary, launches of
    its main paths by wrapper)."""
    import tempfile

    import torch

    times = {}
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg, qparams = build_model(device, "phi4-mini-3.8b", PHI4_LAYERS)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"  (a) peak {peak:.2f} GB allocated while quantizing", flush=True)
    counts, serve = phase_serve(cfg, qparams, device, ["fused_prologue",
                                                       "w4a4_lowrank_matmul"])
    out = {"serve": dict(serve, peak_gb=peak), "held": _phi4_held(cfg, qparams, device)}
    times["a"] = time.perf_counter() - t0
    out["contiguous"] = _contiguous(cfg, qparams, device)
    times["b"] = time.perf_counter() - t0 - sum(times.values())
    del qparams
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out["launcher"] = _launcher(device, Path(tmp))
    times["c"] = time.perf_counter() - t0 - sum(times.values())
    out["moe_train"] = _moe_train(device)
    times["d"] = time.perf_counter() - t0 - sum(times.values())
    out["seconds"] = times
    print("  phase 18 seconds: " + ", ".join(f"({k}) {v:.1f}" for k, v in times.items()),
          flush=True)
    total = dict(counts)
    for more in (out["contiguous"]["launches"], out["launcher"]["walk_launches"],
                 out["launcher"]["serve_launches"],
                 out["launcher"]["serve_launches_in_memory"]):
        for k, v in more.items():
            total[k] = total.get(k, 0) + v
    return out, total


def _ds_absorb(cfg, qparams, device, prompt):
    """(g) ``mla_absorb`` on the served quantized DeepSeek-V2: one prefill
    and DS_ABSORB_DECODES decode calls (B 1), teacher-forced with the naive
    path's greedy tokens, on the naive and the absorbed path.  Every MLA
    attention call of the absorbed run is held to the naive path's on the
    same inputs with ``wkv_b`` as the absorbed path reads it (its effective
    weight, dequantized plus U·Vᵀ, stored bf16 for the naive path's
    expansion): outputs correlated at least ABSORB_MIN_CORRELATION and
    within ABSORB_MAX_REL of the largest.  The model's logits are compared
    too, not gated: the served naive path runs wkv_b as a W4A4 QLinear, and
    any difference of the attention output moves the next layer's 4-bit
    codes and the router's top-6 of 160 experts.  Per-call wall ms and,
    from a profiled window of two decode calls, device-busy ms, beside the
    naive path's."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import mla

    absorbed = dataclasses.replace(cfg, mla_absorb=True)
    toks = torch.from_numpy(prompt[None, :]).to(device)
    held = []
    orig = mla.mla_attention_pre_o

    def held_pre_o(cfg_, p, x, positions, mask, cache=None, route="gather",
                   rope_cs=None, q_start=None):
        out, new_cache = orig(cfg_, p, x, positions, mask, cache, route, rope_cs, q_start)
        eff = dict(p, wkv_b=mla._effective_weight(p["wkv_b"]).to(torch.bfloat16))
        naive, _ = _uncounted(orig, cfg, eff, x, positions, mask, cache, route, rope_cs,
                              q_start)
        a, b = out.double().flatten(), naive.double().flatten()
        held.append((torch.corrcoef(torch.stack([a, b]))[0, 1].item(),
                     ((a - b).abs().max() / b.abs().max()).item()))
        return out, new_cache

    def calls(c, feed=None):
        eng = _ds_engine(c, qparams, device)
        cache = eng._fresh_cache()
        logits, cache = eng._prefill(eng.params, {"tokens": toks}, cache)
        out, walls, feed = [logits[:, -1].float()], [], list(feed or [])
        for i in range(DS_ABSORB_DECODES):
            if i == len(feed):
                feed.append(out[-1].argmax(-1).reshape(1, 1).to(torch.int32))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = eng._decode(eng.params, feed[i], cache)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            out.append(logits[:, -1].float())
        return out, feed, statistics.median(walls) * 1e3, (eng, cache)

    def busy(c, eng, cache, tok):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(2):
                eng._decode(eng.params, tok, cache)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        what = f"decode calls ({'absorbed' if c.mla_absorb else 'naive'})"
        return _device_profile(prof, wall, 2, what, 3)["device_busy_ms_per_step"]

    naive, feed, naive_ms, (eng, cache) = calls(cfg)
    naive_busy = busy(cfg, eng, cache, feed[-1])
    mla.mla_attention_pre_o = held_pre_o
    try:
        served, _, abs_ms, (eng, cache) = calls(absorbed, feed)
    finally:
        mla.mla_attention_pre_o = orig
    abs_busy = busy(absorbed, eng, cache, feed[-1])
    del eng, cache
    finite = all(bool(torch.isfinite(x).all()) for x in served)
    c_logits = min(torch.corrcoef(torch.cat([x, y]))[0, 1].item()
                   for x, y in zip(naive, served))
    want = cfg.n_layers * (1 + DS_ABSORB_DECODES)
    c_min, rel_max = min(h[0] for h in held), max(h[1] for h in held)
    print(f"  (g) mla_absorb, 1 prefill + {DS_ABSORB_DECODES} decode calls: {len(held)} "
          f"MLA attention calls (want {want}) against the naive path on wkv_b's "
          f"effective weight: correlation min {c_min:.6f} (limit "
          f"{ABSORB_MIN_CORRELATION}), max |diff| {rel_max:.3e} of the largest (limit "
          f"{ABSORB_MAX_REL:.3e}); the model's logits against the served naive path's "
          f"(W4A4 wkv_b), correlation min {c_logits:.4f} (not gated); decode call "
          f"wall {abs_ms:.2f} ms absorbed / {naive_ms:.2f} ms naive, device busy "
          f"{abs_busy:.3f} / {naive_busy:.3f} ms", flush=True)
    if not finite or len(held) != want or c_min < ABSORB_MIN_CORRELATION \
            or rel_max > ABSORB_MAX_REL:
        raise SystemExit("(g): the absorbed MLA attention disagrees with the naive one")
    return {"attention_min_correlation": c_min, "attention_max_rel_diff": rel_max,
            "logits_min_correlation": c_logits, "decode_call_ms": abs_ms,
            "naive_decode_call_ms": naive_ms, "device_busy_ms": abs_busy,
            "naive_device_busy_ms": naive_busy}


def _without_streams(tree):
    """The summary without the served token streams phase 15 compared."""
    if isinstance(tree, dict):
        return {k: _without_streams(v) for k, v in tree.items() if k != "streams"}
    if isinstance(tree, list):
        return [_without_streams(v) for v in tree]
    return tree


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

    # the fused kernel: its footprint and plan mirrored from shapes, the
    # int8 tensor cores in its SASS and no __dp4a, its registers and spills
    phase_fused_build()
    from repro_torch.kernels import flash_attn, hadamard, prologue

    # the kernels' normalization constant, (float)(1.0 / sqrt((double)d)) on
    # the host, against the plain version's 1.0 / d**0.5 rounded to f32
    import numpy as np

    lib = hadamard._lib("fwht")
    if lib.fwht_max_d() != hadamard.MAX_D or (
            prologue._lib("fused_prologue").fused_prologue_max_rotate_k() != hadamard.MAX_D):
        raise SystemExit("hadamard.MAX_D is not the sources' widest rotated row")
    for e in range(_log2(hadamard.MAX_D) + 1):
        d = 2 ** e
        c, want = lib.fwht_norm(d), np.float32(1.0 / d**0.5)
        if np.float32(c) != want:
            raise SystemExit(f"fwht_norm({d}) = {c!r} is not 1.0 / {d}**0.5 = {want!r}")
        if d in (2, 512, 8192):
            print(f"  fwht_norm({d}) = {np.float32(c)!r}, 1.0 / {d}**0.5 in f32 = {want!r}",
                  flush=True)
    for name in ("flash_attention", "flash_attention_quant"):
        got = getattr(flash_attn._lib(name), f"{name}_max_d")()
        if got != flash_attn.MAX_D:
            raise SystemExit(f"flash_attn.MAX_D {flash_attn.MAX_D} is not {name}'s {got}")
    for name in ("paged_flash_attention", "paged_flash_attention_quant"):
        lib = flash_attn._lib(name)
        got = (getattr(lib, f"{name}_pages_per_split")(), getattr(lib, f"{name}_warps")())
        if got != (flash_attn.PAGES_PER_SPLIT, flash_attn.SPLIT_WARPS):
            raise SystemExit(f"flash_attn's split ({flash_attn.PAGES_PER_SPLIT} pages, "
                             f"{flash_attn.SPLIT_WARPS} warps) is not {name}'s {got}")
    hmma = _tensor_core_instructions(("flash_attention", "flash_attention_quant"))
    print("  tensor-core (HMMA) instructions in the built SASS: "
          + ", ".join(f"{name} {n}" for name, n in hmma.items()), flush=True)
    if not all(hmma.values()):
        raise SystemExit("a dense flash-attention library holds no tensor-core instruction")
    imma = _tensor_core_instructions(("w4a4_lowrank_matmul",), "IMMA")
    print(f"  integer tensor-core (IMMA) instructions in the built SASS: "
          f"w4a4_lowrank_matmul {imma['w4a4_lowrank_matmul']}", flush=True)
    if not imma["w4a4_lowrank_matmul"]:
        raise SystemExit("the W4A4 GEMM library holds no integer tensor-core instruction")
    from repro_torch.kernels import w4a4

    # w4a4.gemm_plan mirrors the source's plan, from shapes and the SM count
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan_cases = _gemm_plan_cases()
    for m, k, n, g in plan_cases:
        want = w4a4.source_plan(m, k, n, g, sms)
        if w4a4.gemm_plan(m, k, n, g, sms) != want:
            raise SystemExit(f"w4a4.gemm_plan({m}, {k}, {n}, {g}, {sms}) is not the "
                             f"source's {want}")
    print(f"  w4a4.gemm_plan == the source's plan at {len(plan_cases)} shapes ({sms} SMs); "
          f"Phi-3 wd at M {SLOTS}: {w4a4.gemm_plan(SLOTS, 8192, 3072, None, sms)}",
          flush=True)
    # prologue.prologue_plan mirrors the prologue source's plan, the same way
    plan_cases = _prologue_plan_cases()
    for case in plan_cases:
        want = prologue.source_plan(*case, sms)
        if prologue.prologue_plan(*case, sms) != want:
            raise SystemExit(f"prologue.prologue_plan{case + (sms,)} is not the source's {want}")
    print(f"  prologue.prologue_plan == the source's plan at {len(plan_cases)} shapes "
          f"({sms} SMs); Phi-3 wd at M {SLOTS}: "
          f"{prologue.prologue_plan(SLOTS, 8192, 307, False, 2, 2, sms)}", flush=True)
    for entry, regs in _kernel_registers("fused_prologue"):
        print(f"  fused_prologue {entry}: {regs}", flush=True)
    # the quantizer's and the transform's plans mirrored, their registers
    phase_quant_build()

    phase("3. kernels against their plain versions")
    probe = phase_tc_probe(device)
    worst, timed = phase_kernels(device)
    chain_worst, chain_timed = phase_chain_kernels(device)
    rot_worst, rot_timed = phase_rotate_kernels(device)
    attn_worst, attn_timed = phase_attention_kernels(device)
    flash_worst, flash_timed = phase_flash_kernels(device)
    prefill_worst, prefill_timed = phase_prefill_kernels(device)
    flash_worst = max(flash_worst, prefill_worst["flash_attention"])

    phase("4. serve SmolLM-135M (fused path)")
    cfg, qparams = build_model(device)
    smol_counts, serve = phase_serve(cfg, qparams, device, ["fused_w4a4_lrc"], no_memset=True)

    phase("5. SmolLM-135M teacher-forced paged_step, kernel path against int8")
    parity = phase_parity(cfg, qparams, device)  # qparams stay for phase 13

    phase(f"6. serve Phi-3-mini, {PHI3_LAYERS} layers (chained path)")
    pcfg, pparams = build_model(device, "phi3-mini-3.8b", PHI3_LAYERS)
    phi3_counts, phi3_serve = phase_serve(pcfg, pparams, device,
                                          ["fused_prologue", "w4a4_lowrank_matmul"],
                                          route_ab=True, no_memset=True)

    phase("7. Phi-3-mini teacher-forced paged_step, chained and unfused paths")
    paths = phase_paths(pcfg, pparams, device)

    phase("8. serve Phi-3-mini with quantized KV pools (int8, int4 group 32)")
    kv_serve, quant_launches, prefill_quant_launches = {}, 0, 0
    for pool in ATTN_POOLS["paged_flash_attention_quant"]:
        spec = _kv_spec(pool)
        counts, stats = phase_serve(pcfg, pparams, device,
                                    ["fused_prologue", "w4a4_lowrank_matmul"],
                                    kv_spec=spec)
        quant_launches += counts["paged_flash_attention_quant"]
        prefill_quant_launches += counts["flash_attention_quant"]
        kv_serve[pool] = dict(stats, routes=phase_kv_routes(pcfg, pparams, device, spec))

    phase("9. LRC calibration on the card (SmolLM-135M; one Phi-3-mini layer)")
    ccfg, cparams, calib_counts, calib = phase_calibrate(device)
    print("  serving the calibrated SmolLM-135M (fused path, f32 KV):", flush=True)
    calib_serve_counts, calib["serve"] = phase_serve(ccfg, cparams, device,
                                                     ["fused_w4a4_lrc"])
    del cparams

    phase(f"10. long-prompt prefill, Phi-3-mini, {PHI3_LAYERS} layers (f32, int8, "
          f"int4 group 32 pools)")
    long_prefill = phase_long_prefill(pcfg, pparams, device)  # pparams stay for phase 13

    phase("11. the kv_sweep pass, SmolLM-135M (f32, int8, int4 pools)")
    sweep, sweep_counts = phase_kv_sweep(device)

    phase("12. the paper's layer-latency tables (Tables 6-8), rotated and unrotated")
    latency = phase_latency(device)
    lat = latency["launches"]

    phase(f"13. grouped activation scales (SmolLM-135M g {SMOL_GROUP}, Phi-3-mini "
          f"g {PHI3_GROUP})")
    groups, group_worst, group_timed, group_smol, group_phi3 = phase_groups(
        device, cfg, qparams, pcfg, pparams)

    phase("15. the serving contracts: faults and deferred retries, crash recovery, "
          "the serving CLI (SmolLM-135M fused, Phi-3-mini chained with an int8 pool)")
    contracts = phase_contracts(device, card, cfg, qparams, serve["streams"], pcfg,
                                pparams, kv_serve["int8"]["streams"])
    del qparams, pparams

    phase(f"14. Gemma-7b, head_dim 256 ({GEMMA_LAYERS} layers, chained path, prefill "
          f"through the flash kernels at D 256)")
    gemma, gemma_worst, gemma_timed, gemma_counts = phase_gemma(device)

    phase("16. training on the card (a step against the CPU's, SmolLM-135M at full width, "
          "the bitwise resume) and Table 1 on the trained benchmark model")
    train, table1_counts = phase_train(device)

    phase(f"17. serve DeepSeek-V2 at full width, {DEEPSEEK_LAYERS} layers (MLA, "
          f"160 routed experts, 2 shared) in the per-slot engine mode")
    deepseek, ds_worst, ds_sites, ds_flash, ds_counts = phase_deepseek(device)

    phase(f"18. Phi-4-mini at full width ({PHI4_LAYERS} of 32 layers), the dense "
          f"contiguous cache, the quantize launcher, MoE training")
    phase18, phase18_counts = phase_18(device)

    # launches of the two dense kernels on the main paths: every prefill
    # chunk of phases 4, 6, 8, 9 (its served model) and 10, the walk of
    # phase 9, phase 11's pass
    flash_launches = (smol_counts["flash_attention"] + phi3_counts["flash_attention"]
                      + calib_counts["flash_attention"]
                      + calib_serve_counts["flash_attention"]
                      + sum(r["launches"]["flash_attention"]
                            for pool in LONG_POOLS for key, r in long_prefill[pool].items()
                            if key.startswith("kernel/"))
                      + sweep_counts["f32"])
    quant_flash_launches = (prefill_quant_launches
                            + sum(r["launches"]["flash_attention_quant"]
                                  for pool in LONG_POOLS
                                  for key, r in long_prefill[pool].items()
                                  if key.startswith("kernel/"))
                            + sum(n for name, n in sweep_counts.items() if name != "f32"))
    flash_launches += table1_counts["flash_attention"]

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
              smol_counts["fused_w4a4_lrc"] + table1_counts["fused_w4a4_lrc"], SITES, timed,
              worst, at_smol + "; launches from phase 4's serving and phase 16's Table 1 "
              "kernel column"),
        entry("fused_prologue", "src/repro/kernels/prologue.py:93",
              phi3_counts["fused_prologue"] + lat["fused_prologue"], PHI3_SITES, chain_timed,
              chain_worst["fused_prologue"], at_phi3),
        entry("w4a4_lowrank_matmul", "src/repro/kernels/w4a4.py:98",
              phi3_counts["w4a4_lowrank_matmul"] + lat["w4a4_lowrank_matmul"],
              PHI3_SITES, chain_timed, chain_worst["w4a4_lowrank_matmul"], at_phi3),
        entry("act_quant", "src/repro/kernels/actquant.py:31",
              paths["act_quant_launches"] + lat["act_quant"], PHI3_SITES, chain_timed,
              chain_worst["act_quant"], at_phi3 + "; launches from phase 7's unfused run "
              "and phase 12"),
    ]

    # the GEMM's per-site times at both served M, and alone at phase 12's sizes
    site_keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    kernels[2]["sites"] = {f"M{m}_{site}": dict(zip(site_keys, chain_timed[
        ("w4a4_lowrank_matmul", m, *PHI3_SITES[site])])) for m in (SLOTS, CHUNK)
        for site in PHI3_SITES}
    kernels[2]["alone"] = latency["gemm_alone"]
    kernels[3]["alone"] = {f"{'g' + str(g) if g else 'token'}_M{m}_K{k}": dict(zip(
        site_keys, chain_timed[("act_quant_alone", m, k, g)]))
        for g in (None, PHI3_GROUP) for m in QUANT_MS for k in QUANT_KS}
    kernels[0]["sites"] = {f"M{m}_{site}": dict(zip(site_keys, timed[
        ("fused_w4a4_lrc", m, *SITES[site])])) for m in (SLOTS, CHUNK) for site in SITES}
    add_rotation_entries(kernels, rot_worst, rot_timed, lat)
    add_group_entries(kernels, group_worst, group_timed, group_smol, group_phi3,
                      groups["phi3_paths"])

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
    t_k, t_p, b_ms, by, b_cc, t_l = flash_timed["smollm-calib"]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "bound_cuda_core_ms", "library_ms")
    shapes = {k: dict(zip(keys, v)) for k, v in flash_timed.items()}
    for (name, label, pool), v in prefill_timed.items():
        if name == "flash_attention":
            shapes[f"prefill-{label}-{pool}"] = dict(zip(keys, v))
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attn.py:241",
        "launches": flash_launches, "max_abs_err": flash_worst,
        "ms": t_k, "plain_ms": t_p, "bound_ms": b_ms, "bound_by": by,
        "bound_cuda_core_ms": b_cc, "library_ms": t_l, "checked": True,
        "at": (f"one SmolLM-135M calibration layer's causal attention, B="
               f"{SMOL_CALIB_SEQS} S={CALIB_SEQ_LEN} H 9 KH 3 D 64 f32, L2 flushed; "
               f"library: SDPA is_causal on an expanded-KV copy; launches from "
               f"phase 9's walk, every float-pool prefill chunk of phases 4, 6, 9, "
               f"10 and 11, and phase 16's Table 1 (its calibration walks and kernel-"
               f"column forwards, D 32)"),
        "shapes": shapes,
    })
    t_k, t_p, b_ms, by, b_cc, _, t_c = prefill_timed[("flash_attention_quant", "smollm-b4",
                                                       "int8")]
    kernels.append({
        "name": "flash_attention_quant", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_quant.cu",
        "replaces": "src/repro/kernels/flash_attn.py:270",
        "launches": quant_flash_launches,
        "max_abs_err": prefill_worst["flash_attention_quant"],
        "ms": t_k, "plain_ms": t_p, "bound_ms": b_ms, "bound_by": by,
        "bound_cuda_core_ms": b_cc, "library_ms": None, "checked": True,
        "at": ("phase 11's layer call: B 4, S 2048, H 9, KH 3, D 64, int8 K/V, f32 q, "
               "L2 flushed; library none (no PyTorch call attends over quantized K/V; "
               "context_sdpa_ms: SDPA over a pre-dequantized KV-expanded copy); "
               "launches from every quantized-pool prefill chunk of phases 8 and 10 "
               "and phase 11's int8 and int4 passes"),
        "context_sdpa_ms": t_c,
        "shapes": {f"{label}-{pool}": dict(zip(keys + ("context_sdpa_ms",), v))
                   for (name, label, pool), v in prefill_timed.items()
                   if name == "flash_attention_quant"},
    })
    add_gemma_entries(kernels, gemma_worst, gemma_timed, gemma_counts)
    add_deepseek_entries(kernels, ds_worst, ds_sites, ds_flash, ds_counts)
    for entry in kernels:  # phase 18's main paths: (a) to (c)
        n = phase18_counts.get(entry["name"], 0)
        entry["launches"] += n
        entry["phase18_launches"] = n
    summary = {"serve": serve, "parity": parity, "phi3_serve": phi3_serve,
               "phi3_paths": paths, "phi3_kv_serve": kv_serve,
               "calibration": calib, "long_prefill": long_prefill,
               "kv_sweep": sweep, "latency": latency, "groups": groups,
               "gemma": gemma, "tc_probe": probe, "contracts": contracts,
               "train": train, "deepseek": deepseek, "phase18": phase18}
    print(json.dumps(_without_streams(summary), default=str))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
