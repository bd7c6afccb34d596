"""KV-cache quantization sweep (counterpart of ``benchmarks/kv_sweep.py``):
PPL and next-token accuracy of serving a model out of f32, int8 and
int4-g128 paged KV pools, with the bytes each pool stores per token.

The weight path is left as the caller gives it, so the deltas against the
dense forward are the KV pool's alone.  Each sweep point runs the serving
forward (``model.paged_step`` over a paged pool with per-row block tables)
on the full eval sequences, one full-sequence step per batch: on the card
the attention of that step goes through the dense flash kernels over each
row's gathered pages (the quantized one dequantizes each tile on chip), on
the CPU through the reference's gather route unless ``ctx`` asks for the
kernel route (the kernels' plain versions).

The model and the eval batches are arguments: the reference sweeps its
bench model trained on the synthetic corpus, which
``bench.common.get_bench_model`` trains in the port too.

    from repro_torch.bench.kv_sweep import eval_batches, run
    rows = run(cfg, params, eval_batches(cfg))
"""

from __future__ import annotations

import torch

from repro_torch.bench.common import (eval_batches, ppl_acc,  # noqa: F401
                                      ppl_and_acc, score)
from repro_torch.models import model as model_lib
from repro_torch.serve.kvquant import KVSpec

PAGE_SIZE = 16
# the reference serving geometry of the bytes columns (the attn_kb_ columns
# of the reference's benchmarks/latency_kernels.py)
REF_KV_HEADS, REF_HEAD_DIM = 8, 128

SWEEP = [
    ("f32", KVSpec()),
    ("int8", KVSpec(dtype="int8")),
    ("int4-g128", KVSpec(dtype="int4", group=128)),
]

HEADER = ["kv", "ppl", "acc", "delta_ppl", "delta_acc",
          "kv_bytes_per_token", "ref_bytes_per_token", "ref_reduction_vs_f32"]


def paged_step_logits(cfg, params, toks, spec: KVSpec, ctx=None):
    """Logits (B, S, V) of one full-sequence ``paged_step`` over a fresh
    ``spec`` pool, rows on consecutive pages from 1 (page 0 is the null
    page): the prefill of every row at once."""
    b, s = toks.shape
    dev = toks.device
    per_row = -(-s // PAGE_SIZE)
    num_pages = b * per_row + 1
    cache = model_lib.init_paged_cache(cfg, num_pages, PAGE_SIZE,
                                       dtype=torch.float32, device=dev,
                                       kv_spec=spec)
    block_table = torch.arange(1, num_pages, dtype=torch.int32,
                               device=dev).reshape(b, per_row)
    positions = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    valid = torch.ones((b, s), dtype=torch.bool, device=dev)
    logits, _ = model_lib.paged_step(cfg, params, toks, positions, valid, cache,
                                     block_table, kv_spec=spec, ctx=ctx)
    return logits


def paged_ppl_and_acc(cfg, params, evals, spec: KVSpec, ctx=None):
    """PPL and ACC of the serving path: one full-sequence ``paged_step`` per
    batch (chunked prefill with chunk = seq), logits at every position
    scored as next-token CE: the paged analogue of :func:`ppl_and_acc`."""
    return ppl_acc([score(paged_step_logits(cfg, params, batch["tokens"],
                                            spec, ctx), batch["tokens"])
                    for batch in evals])


def run(cfg, params, evals, ctx=None):
    """The sweep's table, as the reference's ``run`` records it: one row
    for the dense forward, then one per pool of ``SWEEP`` with its PPL and
    ACC, their deltas against the forward, and the bytes per token at this
    model's geometry and at the reference geometry.  Returns
    ``(HEADER, rows, {name: (ppl, acc)})``.  The f32 pool is the numerical
    control: it must sit within 5 % of the forward's PPL."""
    fp_ppl, fp_acc = ppl_and_acc(cfg, params, evals, ctx)
    ref_f32 = KVSpec().kv_bytes_per_token(REF_KV_HEADS, REF_HEAD_DIM)
    rows = [["fp-forward", fp_ppl, fp_acc, 0.0, 0.0, "", "", ""]]
    results = {}
    for name, spec in SWEEP:
        ppl, acc = paged_ppl_and_acc(cfg, params, evals, spec, ctx)
        bpt = cfg.n_layers * spec.kv_bytes_per_token(cfg.n_kv_heads, cfg.head_dim)
        ref = spec.kv_bytes_per_token(REF_KV_HEADS, REF_HEAD_DIM)
        rows.append([name, ppl, acc, ppl - fp_ppl, acc - fp_acc, bpt, ref,
                     ref_f32 / ref])
        results[name] = (ppl, acc)
    if not abs(results["f32"][0] - fp_ppl) < 0.05 * fp_ppl:
        raise AssertionError(f"the f32 pool's PPL {results['f32'][0]} is not "
                             f"within 5 % of the forward's {fp_ppl}")
    return HEADER, rows, results
