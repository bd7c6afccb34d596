"""Paper Tables 6-8, layer latency against rank at the Llama matrix sizes
(counterpart of ``benchmarks/latency_kernels.py``), measured on the card.

The paper timed an int4 layer with its low-rank correction and found that
128 ranks already cost 23-52 % extra latency.  Here the W4A4+LRC layer
(``kernels/ops.w4a4_lrc_forward``) runs through the port's kernels:

  * :func:`smoke_rows` — the reference's smoke shapes (decode and mixed M,
    odd N, the rank-1024 K = 8192 shape, the g = 128 group-wise row),
    rotation on and off, through the unfused, chained, fused and "auto"
    paths.  On the CPU (the plain versions) the four outputs must be
    bitwise equal, as the reference's interpret mode promises.  On the card
    every path is held step by step against its plain version
    (:func:`check_path`), and the chained and unfused paths' codes and
    scales must be bitwise equal.
  * :func:`measured_rows` — the card only (it raises elsewhere): every
    paper size whose K is a power of two with the rotation on and off
    (5120 x 13824 unrotated only, K = 5·1024), each rank of ``RANKS``, each
    M of ``MS``, and Phi-3-mini's mlp/wd site (K 8192, N 3072) at rank 0
    and its served rank 307.  Each row has the µs of the unfused and
    chained paths (the fused path where "auto" picks it), of a bf16
    ``torch.matmul`` of the same (M, K, N) (the "fp16" layer the paper
    divides by), the LR overhead against rank 0, and the chained path with
    the paper's g = 128 activation groups (``us_chained_g128``: the
    measured counterpart of the reference's roofline ``_g128`` column).
    Each configuration's output is held once, step by step
    (:func:`check_path`); the last column is the largest |kernel - plain|
    over its bound.

The reference's activation-byte columns need ``launch/roofline.py``, which
is not ported (ROADMAP Queue 1 item 9), and its analytic rows are a model
of another chip: neither is here.

    python -m repro_torch.bench.latency_kernels --device cpu   # smoke rows
    python -m repro_torch.bench.latency_kernels                # the card
"""

from __future__ import annotations

import argparse
from contextlib import contextmanager

import torch

from repro_torch.bench.common import (flush_buffer, gemm_tolerance, lr_tolerance, time_ms,
                                      w4a4_problem, xv_tolerance)
from repro_torch.core.quantizers import QuantSpec
from repro_torch.device import resolve_device
from repro_torch.kernels import actquant, fused_gemm, hadamard, ops, prologue, w4a4
from repro_torch.kernels.context import KERNEL_PATHS, KernelContext
from repro_torch.kernels.rowops import project_rows

# (d_in, d_out) from the Llama family, as in paper Tables 6-8
SIZES = [(4096, 11008), (5120, 13824), (8192, 28672)]
RANKS = [0, 128, 256, 512, 1024]
# decode, mixed and the paper's prefill M
MS = [16, 256, 2048]
# Phi-3-mini's mlp/wd site (K, N) and the ranks measured there: none and
# the served one (rank_frac 0.10 of 3072)
PHI3_WD = (8192, 3072)
PHI3_RANKS = [0, 307]
# the reference's smoke shapes (m, k, n, r, rotate, act_group)
SMOKE_SHAPES = [
    (16, 256, 512, 0, False, None),
    (16, 256, 512, 32, True, None),
    (16, 512, 300, 64, False, None),
    (64, 256, 256, 32, True, None),
    (16, 8192, 256, 1024, True, None),
    (16, 512, 256, 32, True, 128),
]
# the activation group of the measured rows' g = 128 column (paper Table 2)
GROUP = 128
SPEC = QuantSpec(bits=4, clip_ratio=0.9)
# timing repetitions: fewer at M = 2048, where one call takes milliseconds
REPS, REPS_PREFILL, WARMUP = 20, 5, 2
# the wrappers whose launches a forward call makes
KERNEL_MODULES = (fused_gemm, prologue, w4a4, actquant, hadamard)

HEADER = ["matrix", "ranks", "rotate", "us_unfused", "us_chained", "us_fused",
          "auto_path", "us_bf16_matmul", "speedup_vs_bf16_unfused",
          "speedup_vs_bf16_chained", "lr_overhead_unfused",
          "lr_overhead_chained", "us_chained_g128", "max_err_over_bound"]


def is_pow2(k: int) -> bool:
    return k > 0 and k & (k - 1) == 0


class Calls:
    """Forward calls per (path, rotate), to account for kernel launches."""

    def __init__(self):
        self.n = {}

    def forward(self, x, wp, sw, u, v, rotate, impl, group=None):
        ctx = KernelContext()
        path = ctx.resolve_plan(x.shape[0], x.shape[1], wp.shape[1],
                                0 if v is None else v.shape[1], impl=impl,
                                act_group=group).path
        key = (path, rotate)
        self.n[key] = self.n.get(key, 0) + 1
        spec = QuantSpec(bits=SPEC.bits, clip_ratio=SPEC.clip_ratio, group_size=group)
        return ops.w4a4_lrc_forward(x, wp, sw, u, v, spec, rotate=rotate,
                                    impl=impl, ctx=ctx)

    def expected_launches(self) -> dict:
        """The kernel launches these calls make on the card: one transform
        per rotated unfused call and none otherwise, one quantizer per
        unfused call, one prologue per chained call, one GEMM per unfused
        or chained call, one fused kernel per fused call."""
        get = lambda path, rot=None: sum(  # noqa: E731
            c for (p, r), c in self.n.items() if p == path and rot in (None, r))
        return {"fwht": get("unfused", True),
                "act_quant": get("unfused"),
                "fused_prologue": get("chained"),
                "w4a4_lowrank_matmul": get("unfused") + get("chained"),
                "fused_w4a4_lrc": get("fused")}


@contextmanager
def uncounted():
    """Launches made inside, to hold a path against its plain version, are
    not the path's: every wrapper's count is restored afterwards."""
    saved = [(mod, dict(mod.LAUNCHES)) for mod in KERNEL_MODULES]
    try:
        yield
    finally:
        for mod, counts in saved:
            mod.LAUNCHES.update(counts)


def _within(got, want, tol, what) -> float:
    """Raises unless ``got`` is finite and within ``tol`` of ``want``;
    returns the largest |got - want| / tol."""
    err = (got - want).abs()
    if not bool(torch.isfinite(got).all()) or not bool((err <= tol).all()):
        raise AssertionError(f"{what}: |kernel - plain| {err.max().item():.3e} "
                             f"exceeds its bound")
    return (err / tol).max().item()


def _bitwise(got, want, what):
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: not bitwise its plain version")


def check_path(x, wp, sw, u, v, rotate, path, y, group=None):
    """Holds one path's output ``y`` (with activation group ``group``; None:
    per-token) on the card, step by step, so that each bound stays far
    below the values it compares:

      * fused: ``y`` against the plain version within the whole layer's
        bound (``lr_tolerance``; the fused path runs at K <= 1024 only);
      * chained: the prologue kernel's codes and scales bitwise its plain
        version's and its x·V within ``xv_tolerance``;
      * unfused: the transform kernel's rows (rotated) and the quantizer
        kernel's codes and scales bitwise their plain versions', x·V plain
        torch as in the path;
      * both: ``y`` bitwise the GEMM kernel's on those codes, scales and
        x·V, and that within ``gemm_tolerance`` (the R-term sum only) of
        the plain GEMM on the same operands.

    Group-wise the GEMM's sum over groups follows the canonical order on
    the card and in the plain version alike, so the same bounds hold.

    Returns the path's codes and scales (None for fused) and the largest
    |kernel - plain| / bound."""
    k, r = x.shape[1], 0 if v is None else v.shape[1]
    bits, clip = SPEC.bits, SPEC.clip_ratio
    what = f"{path} M{x.shape[0]} K{k} N{wp.shape[1]} R{r} rotate={rotate} group={group}"
    with uncounted():
        if path == "fused":
            rows = hadamard.fwht_plain(x.float()) if rotate else x
            y_plain = fused_gemm.fused_w4a4_lrc_plain(x, v, wp, sw, u, bits, clip, rotate,
                                                      group)
            return None, None, _within(y, y_plain, lr_tolerance(rows, v, u, k, r, y_plain),
                                       what)
        worst = 0.0
        if path == "chained":
            xq, sx, xv = prologue.fused_prologue(x, v, bits, clip, rotate, group)
            pq, psx, pxv = prologue.fused_prologue_plain(x, v, bits, clip, rotate, group)
            if r:
                rows = hadamard.fwht_plain(x.float()) if rotate else x
                worst = _within(xv, pxv, xv_tolerance(rows, v, k, pxv), what + " x·V")
        else:
            xr = x
            if rotate:
                xr = hadamard.fwht(x)
                _bitwise(xr, hadamard.fwht_plain(x), what + " transform")
            xq, sx = actquant.act_quant(xr, bits, clip, group)
            pq, psx = actquant.act_quant_plain(xr, bits, clip, group)
            xv = project_rows(xr.float(), v) if r else None
        _bitwise(xq, pq, what + " codes")
        _bitwise(sx, psx, what + " scales")
        y_k = w4a4.w4a4_lowrank_matmul(xq, sx, wp, sw, xv, u, group)
        if not torch.equal(y, y_k):
            raise AssertionError(f"{what}: the output is not the GEMM kernel's on "
                                 f"the path's own operands")
        y_plain = w4a4.w4a4_lowrank_matmul_plain(xq, sx, wp, sw, xv, u, group)
        worst = max(worst, _within(y_k, y_plain, gemm_tolerance(xv, u, r, y_plain), what))
    return xq, sx, worst


def plan_label(plan, k, r, group=None) -> str:
    """The path "auto" takes, and why it demoted the fused path."""
    if not plan.demoted:
        return plan.path
    if r > fused_gemm.MAX_RANK:
        return f"{plan.path} (rank > {fused_gemm.MAX_RANK})"
    return (f"{plan.path} (fused needs {fused_gemm.smem_bytes(k, r, group)} B > "
            f"{fused_gemm.SMEM_LIMIT} B)")


def smoke_rows(device="cuda", calls: Calls = None):
    """The smoke shapes through all four impls (f32 x and factors, as the
    reference's).  Returns rows of ``HEADER`` with the µs of one call per
    path (the host clock on the CPU)."""
    device = resolve_device(device)
    calls = Calls() if calls is None else calls
    gen = torch.Generator(device=device).manual_seed(0)
    flush = flush_buffer(device)
    rows = []
    for m, k, n, r, rot, g in SMOKE_SHAPES:
        x, v, wp, sw, u = w4a4_problem(gen, m, k, n, r, torch.float32,
                                       torch.float32, device, g)
        plan = KernelContext().resolve_plan(m, k, n, r, act_group=g)
        # the fused kernel holds a whole row tile: on the card it runs where
        # it fits; the plain version on the CPU takes any K
        impls = [p for p in KERNEL_PATHS
                 if p != "fused" or device.type == "cpu" or fused_gemm.fits(k, r, g)]
        outs, times = {}, {}
        for impl in impls + ["auto"]:
            outs[impl] = calls.forward(x, wp, sw, u, v, rot, impl, g)
            times[impl] = 1e3 * time_ms(
                lambda: calls.forward(x, wp, sw, u, v, rot, impl, g), flush, reps=3,
                warmup=1)
        label = smoke_label(m, k, n, r, rot, g)
        worst = 0.0
        if device.type == "cpu":
            if not all(torch.equal(outs["fused"], y) for y in outs.values()):
                raise AssertionError(f"cross-path mismatch at {label}")
        else:
            if not torch.equal(outs["auto"], outs[plan.path]):
                raise AssertionError(f"auto is not its path {plan.path} at {label}")
            codes = {}
            for impl in impls:
                xq, sx, err = check_path(x, wp, sw, u, v, rot, impl, outs[impl], g)
                codes[impl] = (xq, sx)
                worst = max(worst, err)
            # an f32 x: both paths quantize the same rows
            if not all(torch.equal(a, b) for a, b in zip(codes["chained"], codes["unfused"])):
                raise AssertionError(f"codes or scales differ across paths at {label}")
        rows.append([label, r, rot, times["unfused"], times["chained"],
                     times.get("fused"), plan_label(plan, k, r, g), None, None,
                     None, None, None, None, worst])
    return rows


def smoke_label(m, k, n, r, rotate, group) -> str:
    """The row label of one smoke shape."""
    return (f"M{m}_{n}x{k}_r{r}{'_rot' if rotate else ''}"
            f"{f'_g{group}' if group else ''}")


def _configs():
    """(label, k, n, ranks, rotations) of the measured matrices."""
    out = [(f"{n}x{k}", k, n, RANKS, (False, True) if is_pow2(k) else (False,))
           for k, n in SIZES]
    k, n = PHI3_WD
    out.append((f"phi3-wd_{n}x{k}", k, n, PHI3_RANKS, (False, True)))
    return out


def measured_rows(device="cuda", calls: Calls = None, log=None):
    """The measured Tables 6-8 (bf16 x and factors, as a served model's).
    Returns rows of ``HEADER``.  ``log`` (a callable) gets each row as it is
    measured."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("measured rows time the card; the CPU has no such "
                           "numbers (run smoke_rows there)")
    calls = Calls() if calls is None else calls
    bf16 = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(1)
    flush = flush_buffer(device)
    rows = []
    for label, k, n, ranks, rotations in _configs():
        mmax, rmax = max(MS), max(ranks)
        x_all, v_all, wp, sw, u_all = w4a4_problem(gen, mmax, k, n, rmax, bf16,
                                                   bf16, device)
        w_bf16 = torch.randn((k, n), generator=gen, device=device).to(bf16)
        for m in MS:
            x = x_all[:m]
            reps = REPS_PREFILL if m >= 2048 else REPS
            t_mm = 1e3 * time_ms(lambda: torch.matmul(x, w_bf16), flush, reps, WARMUP)
            base = {}
            for rot in rotations:
                for r in ranks:
                    u = u_all[:, :r].contiguous() if r else None
                    v = v_all[:, :r].contiguous() if r else None
                    plan = KernelContext().resolve_plan(m, k, n, r)
                    paths = ["unfused", "chained"] + (["fused"] if plan.path == "fused" else [])
                    t, worst = {}, 0.0
                    for path, g in [(p, None) for p in paths] + [("chained", GROUP)]:
                        y = calls.forward(x, wp, sw, u, v, rot, path, g)
                        worst = max(worst, check_path(x, wp, sw, u, v, rot, path, y, g)[2])
                        del y
                        t[path if g is None else f"{path}_g{g}"] = 1e3 * time_ms(
                            lambda: calls.forward(x, wp, sw, u, v, rot, path, g),
                            flush, reps, WARMUP)
                    if r == 0:
                        base[rot] = t
                    over = {p: t[p] / base[rot][p] - 1.0 for p in ("unfused", "chained")}
                    row = [f"M{m}_{label}", r, rot, t["unfused"], t["chained"],
                           t.get("fused"), plan_label(plan, k, r), t_mm, t_mm / t["unfused"],
                           t_mm / t["chained"], over["unfused"], over["chained"],
                           t[f"chained_g{GROUP}"], worst]
                    rows.append(row)
                    if log is not None:
                        log(row)
        del x_all, wp, sw, u_all, v_all, w_bf16
        torch.cuda.empty_cache()
    return rows


def print_table(rows, header=HEADER, out=print):
    """The rows as CSV lines through ``out``, after the header (None: none)."""
    if header is not None:
        out(",".join(header))
    for row in rows:
        out(",".join("" if c is None else (f"{c:.6g}" if isinstance(c, float) else str(c))
                     for c in row))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    print("# smoke rows")
    print_table(smoke_rows(device))
    if device.type == "cuda":
        print("# measured rows")
        print_table(measured_rows(device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
