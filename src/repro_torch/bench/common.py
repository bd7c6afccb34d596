"""What the port's benchmarks and its card script share (counterpart of
``benchmarks/common.py``): the paper-table setting (the benchmark model,
trained on the synthetic corpus, its calibration and evaluation tokens,
the policies, PPL and next-token accuracy), one random W4A4+LRC problem
family, the bounds that hold a kernel against its plain version, and one
timer.

The paper evaluates WikiText-2 PPL and lm-eval accuracy of public LLMs;
offline, every table is reproduced on a small llama-family model TRAINED
on the synthetic corpus (so quantization deltas move a real metric):

  PPL — exp(next-token CE) on held-out synthetic text,
  ACC — next-token top-1 accuracy (the measurable analogue of the paper's
        lm-eval average).

The trained model is cached under ``results/torch_bench_model`` and the
tables are written under ``results/torch`` (both git-ignored), so the
harnesses share one training run; a cache trained otherwise (another
config, schedule or device) is trained anew.  Each table evaluates a W4A4
model in two columns: ``sim`` (the reference's semantics: fake-quant
QLinears and the reference's gather attention) and the kernel route (the
QLinears pinned to the fused path and attention to the kernel route: on
the card the fused W4A4+LRC kernel at every site and the flash-attention
kernel in every forward, on the CPU their plain versions).

The bounds are elementwise limits on |kernel − plain| where the two differ
only in the order of f32 sums; each is twice the recursive-summation bound
(terms + 1)·2⁻²⁴ of the sum of absolute terms, plus the final rounding.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import time
from pathlib import Path
from typing import Any

import torch

from repro_torch.checkpoint.ckpt import latest_step, load_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.core.quantizers import pack_int4
from repro_torch.data.loader import batches, calib_sequences
from repro_torch.device import resolve_device
from repro_torch.kernels.context import KernelContext
from repro_torch.kernels.rowops import check_group
from repro_torch.models import model as model_lib
from repro_torch.models.config import reduced
from repro_torch.quant.calibrate import quantize_model
from repro_torch.quant.policy import QuantPolicy
from repro_torch.quant.qlinear import retag_qlinear_impl

U_EPS = 2.0 ** -24
TINY = torch.finfo(torch.float32).tiny

ROOT = Path(__file__).resolve().parents[3]
RESULTS = ROOT / "results" / "torch"
BENCH_DIR = ROOT / "results" / "torch_bench_model"

# the benchmark model: llama-family (the paper's Phi-3/Llama setting, scaled)
BENCH_CFG = reduced(
    get_config("smollm-135m"),
    n_layers=4,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=384,
    vocab_size=512,
    tie_embeddings=False,
)
TRAIN_STEPS = 300

# the sim column: the reference's semantics, its gather attention included
SIM_CONTEXT = KernelContext(attention="gather")
# |kernel column − sim column| of one table row: PPL relative, ACC absolute.
# Sound kernels differ from sim only in that they compute the LR term in
# f32 where sim multiplies in bf16; the 4-bit quantizers of later layers
# turn such differences into whole code steps, and ACC, which counts
# argmax hits, moves with them more than PPL.  A faulty kernel reads much
# wider: ``chip_smoke.py`` phase 16(d) evaluates LRC (1)'s kernel column
# with half of the LR ranks and with none, and requires both outside this
# bound.  PERF.md gives the readings on either side.  The exact check of
# the kernel is per call (phase 16(d) holds every #1 call to its plain
# version); this bound is the end-to-end one.
KERNEL_COLUMN_BOUND = {"ppl_rel": 0.005, "acc_abs": 0.02}
# the kernel column: the fused path at every W4A4 site (every BENCH_CFG
# site fits it, so it is also what "auto" resolves to on the card) and the
# kernel route of attention, on either device
KERNEL_IMPL, KERNEL_CONTEXT = "fused", KernelContext(attention="kernel")
# the benchmark model's training run (the reference's)
BENCH_TRAIN = dict(global_batch=16, seq_len=64, lr=3e-3)


def _bench_meta(cfg, steps, dev) -> dict:
    """What a cached benchmark model was trained with, as JSON reads it."""
    meta = dict(cfg=dataclasses.asdict(cfg), steps=steps, device=dev.type, **BENCH_TRAIN)
    return json.loads(json.dumps(meta, default=str))


def get_bench_model(force: bool = False, device="cuda", cfg=BENCH_CFG,
                    steps: int = TRAIN_STEPS, bench_dir=BENCH_DIR, log=None):
    """Train (or load the cached) benchmark model on ``device``: ``steps``
    steps of batch 16 × 64 at lr 3e-3, as the reference trains its own.  A
    cached model is used only where its ``meta.json`` says it was trained
    with this config, these steps and this schedule on this kind of
    device; otherwise it is trained anew."""
    from repro_torch.train.trainer import train

    dev = resolve_device(device)
    bench_dir = Path(bench_dir)
    meta = _bench_meta(cfg, steps, dev)
    meta_file = bench_dir / "meta.json"
    cached = meta_file.exists() and json.loads(meta_file.read_text()) == meta
    if cached and latest_step(bench_dir) == steps and not force:
        like = model_lib.init_params(cfg, 0, device=dev)
        return cfg, load_checkpoint(bench_dir / f"step_{steps:08d}", like, dev)
    log = log or (lambda s: print(f"[bench-train] {s}"))
    state, _, _ = train(cfg, steps=steps, log=log, device=dev, **BENCH_TRAIN)
    save_checkpoint(bench_dir, steps, state.params)
    meta_file.write_text(json.dumps(meta, indent=1))
    return cfg, state.params


def eval_batches(cfg, n: int = 4, bsz: int = 8, seq: int = 64, seed: int = 77,
                 device="cuda"):
    """``n`` held-out batches of ``bsz`` × ``seq`` tokens on ``device``,
    bitwise the reference's."""
    it = batches(cfg, bsz, seq, seed=seed, device=device)
    return [b for _, b in (next(it) for _ in range(n))]


def score(logits, toks):
    """(Σ log p(next token), Σ top-1 hits, count) over every position but
    the last, in f32 as the reference scores."""
    lp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    labels = toks[:, 1:].long()
    ll = torch.gather(lp, -1, labels[..., None])[..., 0]
    pred = torch.argmax(lp, dim=-1)
    return float(ll.sum()), float((pred == labels).sum()), labels.numel()


def ppl_acc(parts):
    """(PPL, ACC) from the :func:`score` of every batch."""
    total_ll = sum(p[0] for p in parts)
    total_acc = sum(p[1] for p in parts)
    total_n = sum(p[2] for p in parts)
    return float(math.exp(-total_ll / total_n)), total_acc / total_n


def ppl_and_acc(cfg, params, evals, ctx=None):
    """PPL and ACC of the cache-free forward (``model.forward``; ``ctx``
    picks its attention route, None = "auto")."""
    with torch.inference_mode():
        return ppl_acc([score(model_lib.forward(cfg, params, batch, ctx=ctx),
                              batch["tokens"]) for batch in evals])


def calib_tokens(cfg, n_seq: int = 24, seq: int = 96, device="cuda"):
    return calib_sequences(cfg, n_seq=n_seq, seq_len=seq, seed=123, device=device)


def make_policy(method: str, rank_frac: float = 0.10, act_group=None,
                act_bits: int = 4, lrc_iters: int = 1,
                quant_method: str = "gptq") -> QuantPolicy:
    """method: quarot | svd | lrc | rtn"""
    correction = {"quarot": "none", "svd": "svd", "lrc": "lrc", "rtn": "none"}[method]
    qm = "rtn" if method == "rtn" else quant_method
    rf = rank_frac if correction != "none" else 0.0
    return QuantPolicy(
        bits=4, act_bits=act_bits, act_group=act_group, rank_frac=rf,
        clip_ratio=0.9, impl="sim", lrc_iters=lrc_iters,
        quant_method=qm, correction=correction,
    )


def quantize(cfg, params, policy, calib):
    """The rotated calibration walk, its attention on "auto" (on the card
    the flash-attention kernel)."""
    return quantize_model(cfg, params, calib, policy, rotate=True)


@dataclasses.dataclass
class Bench:
    """What every table harness reads: the trained model, its calibration
    and evaluation tokens, and where the tables go."""

    cfg: Any
    params: Any
    calib: torch.Tensor
    evals: list
    out_dir: Path = RESULTS


def load_bench(device="cuda") -> Bench:
    """The shared benchmark setting on ``device``."""
    dev = resolve_device(device)
    cfg, params = get_bench_model(device=dev)
    return Bench(cfg, params, calib_tokens(cfg, device=dev), eval_batches(cfg, device=dev))


def evaluate(bench: Bench, params, kernel: bool = True):
    """``(ppl, acc)`` of the sim column and, where ``kernel``, the kernel
    column's after them (:data:`KERNEL_IMPL` and :data:`KERNEL_CONTEXT`:
    on the card the fused kernel and the flash kernel, on the CPU their
    plain versions)."""
    out = ppl_and_acc(bench.cfg, params, bench.evals, SIM_CONTEXT)
    if kernel:
        out += ppl_and_acc(bench.cfg, retag_qlinear_impl(params, KERNEL_IMPL), bench.evals,
                           KERNEL_CONTEXT)
    return out


def record(table: str, rows, header, out_dir=RESULTS):
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"{table}.json"
    out.write_text(json.dumps(dict(header=header, rows=rows), indent=2))
    # CSV to stdout per harness contract
    print(f"# {table}")
    print(",".join(header))
    for r in rows:
        print(",".join(str(x) for x in r))
    return out


def w4a4_problem(gen, m, k, n, r, x_dtype, f_dtype, device, act_group=None):
    """Random x (M, K), packed int4 W (K/2, N), w_scale (N,) and factors
    v (K, R), u (N, R) (None at R = 0) on ``device``, drawn from ``gen``.
    ``act_group`` (the activation scale group the problem is run with;
    None: per-token) must divide K.  Returns (x, v, wp, sw, u)."""
    if act_group is not None:
        check_group(k, act_group)
    x = torch.randn((m, k), generator=gen, device=device).to(x_dtype)
    q = torch.randint(-8, 8, (k, n), generator=gen, device=device, dtype=torch.int8)
    wp = pack_int4(q.T).T.contiguous()
    sw = torch.rand((n,), generator=gen, device=device) * 0.02 + 0.001
    u = v = None
    if r:
        u = (torch.randn((n, r), generator=gen, device=device) * 0.05).to(f_dtype)
        v = (torch.randn((k, r), generator=gen, device=device) * 0.05).to(f_dtype)
    return x, v, wp, sw, u


def lr_tolerance(x, v, u, k, r, y_plain):
    """Bound on the whole W4A4+LRC output from the same rows x: the codes,
    scales and integer GEMM are exact, only the two LR sums (K terms of
    x·V, R terms of xv·Uᵀ) are ordered differently.  Tight only where K and
    R are small against the output; wider sites are held in two steps
    (:func:`xv_tolerance`, then :func:`gemm_tolerance`)."""
    mag = y_plain.abs()
    if r:
        mag = mag + (x.float().abs() @ v.float().abs()) @ u.float().abs().T
    return 2.0 * (k + r + 1) * U_EPS * mag + TINY


def xv_tolerance(x, v, k, xv_plain):
    """Bound on x·V from the same rows x: its K-term sum."""
    mag = x.float().abs() @ v.float().abs() + xv_plain.abs()
    return 2.0 * (k + 1) * U_EPS * mag + TINY


def gemm_tolerance(xv, u, r, y_plain):
    """Bound on the GEMM output from the same xq, sx and xv: the integer
    part and its rescale are bitwise, only the R-term LR sum is ordered
    differently."""
    mag = y_plain.abs()
    if r:
        mag = mag + xv.abs() @ u.float().abs().T
    return 2.0 * (r + 1) * U_EPS * mag + TINY


def time_ms(fn, flush=None, reps=30, warmup=5):
    """Median time of one call, in ms.  On the card (``flush`` a device
    buffer larger than its 50 MB L2): CUDA events around each call, the L2
    flushed before it, since a served layer's weights are cold when it
    runs.  Without ``flush`` (the CPU): the host clock, a CPU number."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if flush is None:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
            continue
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


def flush_buffer(device):
    """A buffer larger than the card's L2 for :func:`time_ms` (None off
    the card)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.empty(64 * 2**20, dtype=torch.uint8, device=device)
