"""Paper Table 3 — weight-only quantization, Q_a = identity (counterpart
of ``benchmarks/table3_weightonly.py``).

Claim: all methods are near-lossless at W4A16 — low-rank correction buys
nothing when activations stay FP.

W4A16 has no kernel: the port's kernels quantize activations to 4 bits.
The reference evaluates this table on its ``sim`` path, and so does the
port (one column, the reference's gather attention).

    PYTHONPATH=src python -m repro_torch.bench.table3_weightonly
"""

from __future__ import annotations

from repro_torch.bench.common import (Bench, evaluate, load_bench, make_policy,
                                      quantize, record)

HEADER = ["method", "ppl", "acc"]


def run(device="cuda", bench: Bench = None):
    bench = bench or load_bench(device)
    cfg, params = bench.cfg, bench.params
    rows = []
    fp = evaluate(bench, params, kernel=False)
    rows.append(["FP16", round(fp[0], 4), round(fp[1], 4)])
    out = {"FP16": fp}
    for name, method in [("QuaRot", "quarot"), ("SVD", "svd"), ("LRC", "lrc")]:
        qp = quantize(cfg, params, make_policy(method, act_bits=16), bench.calib)
        r = evaluate(bench, qp, kernel=False)
        rows.append([name, round(r[0], 4), round(r[1], 4)])
        out[name] = r
    record("table3_weightonly", rows, HEADER, bench.out_dir)
    return out


if __name__ == "__main__":
    run()
