"""Benchmark harness — one entry per paper table/figure (counterpart of
``benchmarks/run.py``).

    PYTHONPATH=src python -m repro_torch.bench.run [--device cpu]

Trains (or loads the cached) benchmark model once, runs the five table and
figure harnesses on it and then ``bench.latency_kernels``, and prints
``name,us_per_call,derived`` CSV summary lines after each table's full CSV;
the tables' JSON lands in ``results/torch``.  On ``--device cpu`` the
tables' kernel columns run the kernels' plain versions
(``common.evaluate``).
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.bench import (fig2_rank_sweep, fig3_quantizer, latency_kernels,
                                   table1_w4a4, table2_groups, table3_weightonly)
    from repro_torch.bench.common import load_bench
    from repro_torch.device import resolve_device

    device = resolve_device(args.device)
    t0 = time.time()
    bench = load_bench(device)
    print(f"bench model ready in {time.time() - t0:.1f} s on {device}")
    summary = []
    for name, fn in [
        ("table1_w4a4", lambda: table1_w4a4.run(bench=bench)),
        ("table2_groups", lambda: table2_groups.run(bench=bench)),
        ("table3_weightonly", lambda: table3_weightonly.run(bench=bench)),
        ("fig2_rank_sweep", lambda: fig2_rank_sweep.run(bench=bench)),
        ("fig3_quantizer", lambda: fig3_quantizer.run(bench=bench)),
        ("latency_kernels", lambda: latency_kernels.main(["--device", str(device)])),
    ]:
        t0 = time.time()
        derived = fn()
        us = (time.time() - t0) * 1e6
        summary.append((name, us, _derived_str(name, derived)))
        print()
    print("name,us_per_call,derived")
    for name, us, derived in summary:
        print(f"{name},{us:.0f},{derived}")
    return 0


def _derived_str(name: str, derived) -> str:
    if name == "table1_w4a4":
        gap = (derived["FP16"][1] - derived["LRC (1)"][1]) / max(
            1e-9, derived["FP16"][1] - derived["QuaRot"][1])
        return f"lrc_closes_{100 * (1 - gap):.0f}pct_of_gap"
    if name == "fig2_rank_sweep":
        fp_acc, curves = derived
        acc30 = curves[(None, 0.30)][1]
        return f"rank30_acc_within_{abs(fp_acc - acc30):.4f}_of_fp"
    if name == "latency_kernels":
        return "fused_kernel_roofline_table"
    return "ok"


if __name__ == "__main__":
    raise SystemExit(main())
