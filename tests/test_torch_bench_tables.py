"""The port's paper-table setting and harnesses (``repro_torch/bench``:
``common``'s benchmark model, tokens, policies and ``ppl_and_acc``; Tables
1–3 and Figures 2–3; ``run``) against the reference's ``benchmarks/``.

* ``BENCH_CFG``, ``TRAIN_STEPS``, the evaluation and calibration tokens and
  every ``make_policy`` field equal the reference's.
* ``ppl_and_acc`` on bridged reference params (the reduced SmolLM, f32)
  against the reference's: PPL relative 1e-5 (measured 3e-7: the f32 sums
  of two frameworks), the same next-token hits.
* Each harness at a tiny size (the reduced model trained a few steps, a few
  calibration and evaluation sequences) writes the reference's header and
  row names (the reference's own ``run`` is driven with stubbed
  calibration and evaluation to read them), the kernel column appended
  where the port adds it.  The kernel column runs the plain versions of the
  fused W4A4+LRC kernel and the flash-attention kernel (impl "fused",
  ``attention="kernel"``), with exact launch counts, and stays within
  ``TINY_BOUND`` of the sim column.

The card script holds Table 1's kernel column to
``bench.common.KERNEL_COLUMN_BOUND`` (PPL 0.5 %, ACC 0.02) at the
benchmark model's size, trained 300 steps, where sound kernels and faulty
ones (part of the LR term dropped) read on either side of it (its comment
says where).  The tiny model here, trained 30 steps and scored on 248 next
tokens, spreads wider: this fixture at 4, 30, 60 and 100 training steps
gave a worst row 1.16 % off in PPL and 0.032 (8 tokens) in ACC, so it is
held to ``TINY_BOUND``.  ``get_bench_model`` reuses a cached model only
where it was trained as asked.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import benchmarks.common as jax_common
import benchmarks.fig2_rank_sweep as jax_fig2
import benchmarks.fig3_quantizer as jax_fig3
import benchmarks.table1_w4a4 as jax_table1
import benchmarks.table2_groups as jax_table2
import benchmarks.table3_weightonly as jax_table3
from repro_torch import bridge
from repro_torch.bench import (common, fig2_rank_sweep, fig3_quantizer, run,
                               table1_w4a4, table2_groups, table3_weightonly)
from repro_torch.kernels import flash_attn, fused_gemm
from repro_torch.models.config import reduced
from torch_parity import configs, jax_params, to_numpy_tree

# |kernel − sim| of a row of the tiny tables: PPL relative, ACC absolute
TINY_BOUND = {"ppl_rel": 0.03, "acc_abs": 0.05}

PORTED = [(table1_w4a4, jax_table1), (table2_groups, jax_table2),
          (table3_weightonly, jax_table3), (fig2_rank_sweep, jax_fig2),
          (fig3_quantizer, jax_fig3)]
KERNEL_COLUMNS = {"table1_w4a4": ["ppl_kernel", "acc_kernel"], "table2_groups": [],
                  "table3_weightonly": [], "fig2_rank_sweep": ["ppl_kernel", "acc_kernel"],
                  "fig3_quantizer": ["ppl_kernel", "acc_kernel"]}


def test_bench_config_and_steps_match_reference():
    for f in common.BENCH_CFG.__dataclass_fields__:
        assert getattr(common.BENCH_CFG, f) == getattr(jax_common.BENCH_CFG, f), f
    assert common.TRAIN_STEPS == jax_common.TRAIN_STEPS


def test_tokens_bitwise_reference():
    cfg = common.BENCH_CFG
    got = common.eval_batches(cfg, device="cpu")
    want = jax_common.eval_batches(jax_common.BENCH_CFG)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert np.array_equal(g["tokens"].numpy(), np.asarray(w["tokens"]))
    assert np.array_equal(common.calib_tokens(cfg, device="cpu").numpy(),
                          np.asarray(jax_common.calib_tokens(jax_common.BENCH_CFG)))


@pytest.mark.parametrize("kw", [dict(method="quarot"), dict(method="svd"), dict(method="lrc"),
                                dict(method="rtn"), dict(method="lrc", lrc_iters=5),
                                dict(method="lrc", act_group=64, rank_frac=0.3),
                                dict(method="svd", act_bits=16),
                                dict(method="quarot", quant_method="rtn"),
                                dict(method="lrc", quant_method="rtn")])
def test_make_policy_matches_reference(kw):
    got, want = common.make_policy(**kw), jax_common.make_policy(**kw)
    for f in got.__dataclass_fields__:
        assert getattr(got, f) == getattr(want, f), f


def test_ppl_and_acc_match_reference():
    jcfg, tcfg = configs()
    jparams = jax_params(jcfg)
    jev = jax_common.eval_batches(jcfg, n=2)
    want = jax_common.ppl_and_acc(jcfg, jparams, jev)
    params = bridge.params_from_jax(to_numpy_tree(jparams), device="cpu")
    evals = common.eval_batches(tcfg, n=2, device="cpu")
    for g, w in zip(evals, jev):
        assert np.array_equal(g["tokens"].numpy(), np.asarray(w["tokens"]))
    got = common.ppl_and_acc(tcfg, params, evals, common.SIM_CONTEXT)
    assert abs(got[0] - want[0]) <= 1e-5 * want[0]
    assert got[1] == want[1]


def _reference_layout(jax_mod, monkeypatch):
    """(header, rows) the reference harness records, its calibration and
    evaluation stubbed out (a constant score for every model)."""
    seen = {}
    stubs = dict(get_bench_model=lambda: (jax_common.BENCH_CFG, None),
                 calib_tokens=lambda cfg: None, eval_batches=lambda cfg: None,
                 quantize=lambda *a: None, ppl_and_acc=lambda *a: (1.0, 0.5),
                 record=lambda table, rows, header: seen.update(
                     table=table, rows=rows, header=header),
                 retag_qlinear_impl=lambda p, impl: p)
    for name, stub in stubs.items():
        if hasattr(jax_mod, name):
            monkeypatch.setattr(jax_mod, name, stub)
    jax_mod.run()
    return seen


@pytest.fixture(scope="module")
def tiny_bench(tmp_path_factory):
    """The reduced SmolLM (2 layers, d_model 64, untied head) trained 30
    steps, 8 × 32 calibration tokens, 2 evaluation batches of 4 × 32, the
    kernel column on the plain versions."""
    cfg = reduced(common.BENCH_CFG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                  head_dim=16, d_ff=128, vocab_size=256)
    root = tmp_path_factory.mktemp("bench")
    logs = []
    cfg, params = common.get_bench_model(device="cpu", cfg=cfg, steps=30,
                                         bench_dir=root / "model", log=logs.append)
    assert logs[0].startswith("step 0: loss=")
    trained = len(logs)
    again = common.get_bench_model(device="cpu", cfg=cfg, steps=30, bench_dir=root / "model",
                                   log=logs.append)[1]
    assert len(logs) == trained and torch.equal(again["embed"], params["embed"])  # the cache
    return common.Bench(cfg, params, common.calib_tokens(cfg, 8, 32, device="cpu"),
                        common.eval_batches(cfg, 2, 4, 32, device="cpu"),
                        out_dir=root / "tables")


def test_bench_model_cache_keyed_by_its_training(tmp_path):
    """A cached benchmark model is reused only where its ``meta.json`` says
    it was trained with this config, these steps and on this kind of
    device; otherwise it is trained anew."""
    cfg = reduced(common.BENCH_CFG, n_layers=1, d_model=32, n_heads=2, n_kv_heads=1,
                  head_dim=16, d_ff=64, vocab_size=64)
    logs = []

    def get(c):
        return common.get_bench_model(device="cpu", cfg=c, steps=2, bench_dir=tmp_path,
                                      log=logs.append)[1]

    get(cfg)
    trained = len(logs)
    assert trained and len(get(cfg)) and len(logs) == trained
    meta = json.loads((tmp_path / "meta.json").read_text())
    assert (meta["device"], meta["steps"], meta["lr"], meta["cfg"]["d_ff"]) == ("cpu", 2, 3e-3, 64)
    wider = get(dataclasses.replace(cfg, d_ff=96))
    assert len(logs) == 2 * trained and wider["layers"][0]["mlp"]["wg"].shape[-1] == 96
    (tmp_path / "meta.json").write_text(json.dumps(dict(meta, device="cuda")))
    get(cfg)
    assert len(logs) == 3 * trained


def _models(table: str) -> int:
    """The quantized models a harness evaluates on its kernel column."""
    return {"table1_w4a4": 4, "table2_groups": 4, "table3_weightonly": 0,
            "fig2_rank_sweep": 12, "fig3_quantizer": 4}[table]


@pytest.mark.parametrize("mod,jax_mod", PORTED, ids=[m.__name__.split(".")[-1] for m, _ in PORTED])
def test_harness_rows_and_kernel_column(tiny_bench, mod, jax_mod, monkeypatch):
    ref = _reference_layout(jax_mod, monkeypatch)
    table = ref["table"]
    fused_gemm.reset_launches()
    flash_attn.reset_launches()
    mod.run(bench=tiny_bench)
    got = json.loads((Path(tiny_bench.out_dir) / f"{table}.json").read_text())
    assert got["header"] == ref["header"] + KERNEL_COLUMNS[table]
    assert [r[0] for r in got["rows"]] == [r[0] for r in ref["rows"]]
    if table == "fig2_rank_sweep":
        assert [r[1] for r in got["rows"]] == [r[1] for r in ref["rows"]]
    cfg, n_eval = tiny_bench.cfg, len(tiny_bench.evals)
    kernel_evals = 0 if table == "table3_weightonly" else 1 + _models(table)
    assert flash_attn.LAUNCHES["flash_attention_plain"] == kernel_evals * n_eval * cfg.n_layers
    assert flash_attn.LAUNCHES["flash_attention"] == 0
    assert fused_gemm.LAUNCHES["fused_w4a4_lrc_plain"] == \
        _models(table) * n_eval * cfg.n_layers * 7 * (table != "table3_weightonly")
    h = got["header"]
    for row in got["rows"]:
        if row[0] == "lrc_gap_closed_frac":
            continue
        vals = dict(zip(h, row))
        sim = [vals.get(k) for k in ("ppl", "acc", "ppl_sim", "acc_sim") if k in vals]
        ker = [vals.get(k) for k in ("ppl_kernel", "acc_kernel", "ppl_fused", "acc_fused")
               if k in vals]
        assert all(np.isfinite(v) for v in sim + ker)
        if ker:
            assert abs(ker[0] - sim[0]) <= TINY_BOUND["ppl_rel"] * sim[0], row
            assert abs(ker[1] - sim[1]) <= TINY_BOUND["acc_abs"], row


def test_run_summary(monkeypatch, capsys, tiny_bench):
    """``bench.run`` runs the five harnesses on one shared model, then the
    kernel table, and prints the reference's summary lines."""
    order = []
    derived = {"table1_w4a4": {"FP16": (1.0, 0.5), "QuaRot": (2.0, 0.3),
                               "LRC (1)": (1.5, 0.45)},
               "fig2_rank_sweep": (0.5, {(None, 0.30): (1.2, 0.49)})}

    def stub(name):
        def fake_run(bench):
            order.append((name, bench))
            return derived.get(name, {})
        return fake_run

    for mod, _ in PORTED:
        monkeypatch.setattr(mod, "run", stub(mod.__name__.split(".")[-1]))
    monkeypatch.setattr(common, "load_bench", lambda device: tiny_bench)
    from repro_torch.bench import latency_kernels

    monkeypatch.setattr(latency_kernels, "main", lambda argv: order.append(("lat", argv)) or 0)
    assert run.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [o[0] for o in order] == [
        "table1_w4a4", "table2_groups", "table3_weightonly", "fig2_rank_sweep",
        "fig3_quantizer", "lat"]
    assert all(o[1] is tiny_bench for o in order[:5]) and order[5][1] == ["--device", "cpu"]
    i = out.index("name,us_per_call,derived")
    assert out[i + 1].startswith("table1_w4a4,") and out[i + 1].endswith(
        ",lrc_closes_75pct_of_gap")
    assert out[i + 4].endswith(",rank30_acc_within_0.0100_of_fp")
    assert out[i + 6].endswith(",fused_kernel_roofline_table")
    with pytest.raises(RuntimeError, match="is_available"):
        run.main([])  # the card by default; there is none here
