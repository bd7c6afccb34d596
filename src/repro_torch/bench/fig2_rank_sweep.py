"""Paper Figure 2 — accuracy vs. rank fraction at W4A4, with and without
activation groups (counterpart of ``benchmarks/fig2_rank_sweep.py``).
Claim: 10% already beats QuaRot; ~30% closes the gap.

Every point is evaluated on the sim column and on the kernel column (on
the card the fused W4A4+LRC kernel, its group branch at g 64).

    PYTHONPATH=src python -m repro_torch.bench.fig2_rank_sweep
"""

from __future__ import annotations

from repro_torch.bench.common import (Bench, evaluate, load_bench, make_policy,
                                      quantize, record)

FRACS = [0.0, 0.05, 0.10, 0.20, 0.30, 0.50]
HEADER = ["method", "rank_frac", "ppl", "acc", "ppl_kernel", "acc_kernel"]


def run(device="cuda", bench: Bench = None):
    """Returns ``(fp_acc, {(group, frac): (ppl, acc, ppl_kernel,
    acc_kernel)})``."""
    bench = bench or load_bench(device)
    cfg, params = bench.cfg, bench.params
    fp = evaluate(bench, params)
    rows = [["FP16", "-"] + [round(v, 4) for v in fp]]
    curves = {}
    for group in (None, 64):
        for frac in FRACS:
            method = "lrc" if frac > 0 else "quarot"
            qp = quantize(cfg, params, make_policy(method, rank_frac=frac, act_group=group),
                          bench.calib)
            r = evaluate(bench, qp)
            tag = f"g{group or 0}"
            rows.append([f"LRC[{tag}]" if frac else f"QuaRot[{tag}]", frac]
                        + [round(v, 4) for v in r])
            curves[(group, frac)] = r
    record("fig2_rank_sweep", rows, HEADER, bench.out_dir)
    return fp[1], curves


if __name__ == "__main__":
    run()
