"""Paper Table 1 — W4A4, no group-scaling (counterpart of
``benchmarks/table1_w4a4.py``).

Methods: FP16, QuaRot (GPTQ, no correction), SVD (rank 10%), LRC(1), LRC(5).
Claim validated: LRC recovers >50% of the QuaRot→FP gap; SVD does not.

Every row is evaluated on the sim column (the reference's semantics) and
on the kernel column (on the card: the fused W4A4+LRC kernel at every site,
the flash-attention kernel in every forward); the closed-gap row gives the
fraction on both.

    PYTHONPATH=src python -m repro_torch.bench.table1_w4a4
"""

from __future__ import annotations

import time

from repro_torch.bench.common import (Bench, evaluate, load_bench, make_policy,
                                      quantize, record)

HEADER = ["method", "ppl", "acc", "quant_seconds", "ppl_kernel", "acc_kernel"]
METHODS = [
    ("QuaRot", "quarot", 1),
    ("SVD", "svd", 1),
    ("LRC (1)", "lrc", 1),
    ("LRC (5)", "lrc", 5),
]


def closed_frac(fp_acc: float, quarot_acc: float, lrc_acc: float) -> float:
    """The fraction of the QuaRot accuracy gap that LRC closes."""
    gap_quarot = fp_acc - quarot_acc
    return 1.0 - (fp_acc - lrc_acc) / gap_quarot if gap_quarot > 0 else 1.0


def run(device="cuda", bench: Bench = None, timings: dict = None):
    """Returns ``{method: (ppl, acc, ppl_kernel, acc_kernel)}``; ``timings``
    (a dict) receives each method's calibration and evaluation seconds."""
    bench = bench or load_bench(device)
    cfg, params = bench.cfg, bench.params
    rows = []
    t0 = time.time()
    results = {"FP16": evaluate(bench, params)}
    fp = results["FP16"]
    rows.append(["FP16", round(fp[0], 4), round(fp[1], 4), 0.0,
                 round(fp[2], 4), round(fp[3], 4)])
    if timings is not None:
        timings["FP16"] = dict(eval_s=time.time() - t0)
    for name, method, iters in METHODS:
        t0 = time.time()
        qp = quantize(cfg, params, make_policy(method, lrc_iters=iters), bench.calib)
        t1 = time.time()
        r = evaluate(bench, qp)
        t2 = time.time()
        rows.append([name, round(r[0], 4), round(r[1], 4), round(t2 - t0, 1),
                     round(r[2], 4), round(r[3], 4)])
        results[name] = r
        if timings is not None:
            timings[name] = dict(quant_s=t1 - t0, eval_s=t2 - t1)

    # paper claim: LRC closes >50% of the accuracy gap vs QuaRot
    closed = [closed_frac(results["FP16"][i], results["QuaRot"][i], results["LRC (1)"][i])
              for i in (1, 3)]
    rows.append(["lrc_gap_closed_frac", round(closed[0], 3), "", "",
                 round(closed[1], 3), ""])
    record("table1_w4a4", rows, HEADER, bench.out_dir)
    return results


if __name__ == "__main__":
    run()
