"""Paper Figure 3 — LRC composed with different weight quantizers (GPTQ vs
RTN) at W4A4 (counterpart of ``benchmarks/fig3_quantizer.py``).  Claim:
LRC always improves its baseline, and the gain is larger for the weaker
quantizer (RTN).

Every row is evaluated on the sim column and on the kernel column.

    PYTHONPATH=src python -m repro_torch.bench.fig3_quantizer
"""

from __future__ import annotations

from repro_torch.bench.common import (Bench, evaluate, load_bench, make_policy,
                                      quantize, record)

HEADER = ["method", "ppl", "acc", "ppl_kernel", "acc_kernel"]


def run(device="cuda", bench: Bench = None):
    """Returns ``{(quant_method, correction): (ppl, acc, ppl_kernel,
    acc_kernel)}``."""
    bench = bench or load_bench(device)
    cfg, params = bench.cfg, bench.params
    fp = evaluate(bench, params)
    rows = [["FP16"] + [round(v, 4) for v in fp]]
    out = {}
    for qm in ("gptq", "rtn"):
        for corr in ("quarot", "lrc"):
            qp = quantize(cfg, params, make_policy(corr, quant_method=qm), bench.calib)
            r = evaluate(bench, qp)
            name = f"{qm.upper()}{'+LRC' if corr == 'lrc' else ''}"
            rows.append([name] + [round(v, 4) for v in r])
            out[(qm, corr)] = r
    record("fig3_quantizer", rows, HEADER, bench.out_dir)
    return out


if __name__ == "__main__":
    run()
