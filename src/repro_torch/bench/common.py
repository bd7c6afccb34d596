"""What the port's benchmarks and its card script share (counterpart of
``benchmarks/common.py``): one random W4A4+LRC problem family, the bounds
that hold a kernel against its plain version, and one timer.

The bounds are elementwise limits on |kernel − plain| where the two differ
only in the order of f32 sums; each is twice the recursive-summation bound
(terms + 1)·2⁻²⁴ of the sum of absolute terms, plus the final rounding.
"""

from __future__ import annotations

import statistics
import time

import torch

from repro_torch.core.quantizers import pack_int4
from repro_torch.kernels.rowops import check_group

U_EPS = 2.0 ** -24
TINY = torch.finfo(torch.float32).tiny


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
