"""Paper Table 2 — W4A4 with activation group-scaling (counterpart of
``benchmarks/table2_groups.py``; paper: 128, scaled to the bench model's
d_ff granularity: 64).

Each quantized model is evaluated on the sim column (the reference's
semantics) and on the kernel column: its QLinears on the fused path,
which on the card runs the fused W4A4+LRC kernel's group branch with the
(M, K/g) scale plane at every site, attention through the flash kernel.
The header keeps the reference's ``fused`` name for that column.

    PYTHONPATH=src python -m repro_torch.bench.table2_groups
"""

from __future__ import annotations

from repro_torch.bench.common import (Bench, evaluate, load_bench, make_policy,
                                      quantize, record)
from repro_torch.bench.table1_w4a4 import METHODS

GROUP = 64
HEADER = ["method", "ppl_sim", "acc_sim", "ppl_fused", "acc_fused"]


def run(device="cuda", bench: Bench = None):
    """Returns ``{method: (ppl_kernel, acc_kernel)}``, the reference's
    return value on the kernel column."""
    bench = bench or load_bench(device)
    cfg, params = bench.cfg, bench.params
    rows = []
    fp = evaluate(bench, params)
    rows.append(["FP16"] + [round(v, 4) for v in fp])
    out = {"FP16": fp[2:]}
    for name, method, iters in METHODS:
        qp = quantize(cfg, params, make_policy(method, lrc_iters=iters, act_group=GROUP),
                      bench.calib)
        r = evaluate(bench, qp)
        rows.append([name] + [round(v, 4) for v in r])
        out[name] = r[2:]
    record("table2_groups", rows, HEADER, bench.out_dir)
    return out


if __name__ == "__main__":
    run()
