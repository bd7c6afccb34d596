"""Serving launcher of the port: batched requests through a (quantized) model
on the card (counterpart of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        [--full [--layers L]] [--quantize [--act-group G]] [--requests 8] \\
        [--new-tokens 16] \\
        [--page-size 16] [--kv-pages N] [--prefill-chunk C] \\
        [--kv-dtype int8|int4 --kv-group G] \\
        [--deadline-s 30] [--retries 2] [--queue-bound 64] \\
        [--inject-faults K --fault-seed S --parity-check] [--device cpu]

The model is the config's reduced form (``--full`` for its published
widths and depth; ``--layers L`` keeps its first L layers) with random
weights from seed 0.  ``--arch deepseek-v2-236b`` or ``deepseek-v3-671b``
serves the moe family in the engine's per-slot mode (B=1 latent caches;
``--prefill-chunk`` and a quantized ``--kv-dtype`` need the paged layout
and are refused); at full width it needs ``--layers`` on one card (2:
DeepSeek-V2's dense layer and one MoE layer).  ``--quantize`` makes
every linear W4A4+LRC by RTN with an SVD correction (rank 10 %, clip 0.9,
no rotation; ``quant/calibrate.quantize_model``), and ``--impl`` picks the
QLinear path the engine serves (``auto``: the kernel paths on the card, the
calibrated impl on the CPU).  Everything runs on ``--device`` (``cuda`` by
default, which raises without a card; ``cpu`` runs the kernels' plain
versions).

Robustness knobs map onto the engine's request lifecycle
(``serve/lifecycle.py``): per-request deadlines, bounded retries with
backoff, a bounded admission queue and a stall watchdog.  With
``--inject-faults K`` a seeded ``FaultInjector`` (``serve/faults.py``)
targets K of the N requests with hard faults; the launcher then checks the
split — exactly K FAILED/TIMED_OUT records, N-K FINISHED — and returns 1
on any mismatch.  ``--parity-check`` replays the same requests fault-free
and checks that the untargeted completions are bitwise identical.

Crash recovery::

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 8 \\
        --journal run/journal.wal --ckpt-dir run \\
        --snapshot-every 4 --crash-after 2 [--crash-phase decode] \\
        --parity-check

``--crash-after K`` schedules one seeded ``process_crash`` fault: the engine
dies (``SimulatedCrash`` unwinds ``run()``) on the K-th hit of the chosen
phase for a seed-picked rid, leaving only the write-ahead journal and the
last snapshot.  The launcher then calls ``ServeEngine.restore`` and checks
the recovery contract: the journal replays cleanly, every request
terminates exactly once (``collate`` rejects double delivery and double
terminals), and with ``--parity-check`` every token stream is bitwise the
uninterrupted run's.  On a violation it writes ``recovery_failure.json``
beside the journal and returns 1.  ``--journal`` and ``--ckpt-dir`` also
work without ``--crash-after``, to journal or snapshot a normal run.

Not here yet: ``--mesh`` (sharded serving waits for the port's
``torch.distributed`` layer, ROADMAP Queue 1 item 6) and ``--block-table`` /
``--vmem-budget`` (a TPU plan table; they wait for the Hopper plan table of
Queue 1 item 7).
"""

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time


def _positive_int(s):
    v = int(s)
    if v <= 0:
        raise argparse.ArgumentTypeError(f"must be a positive integer, got {s}")
    return v


def _print_failure_summary(done, health, injector=None):
    from repro_torch.serve.lifecycle import RequestState

    by_status = {}
    for rec in done.values():
        by_status.setdefault(rec.status.value, []).append(rec)
    print("request status: " + "  ".join(
        f"{status}={len(recs)}" for status, recs in sorted(by_status.items())))
    for rec in sorted(done.values(), key=lambda r: r.rid):
        if rec.status is RequestState.FINISHED:
            continue
        print(f"  rid {rec.rid}: {rec.status.value} "
              f"[{rec.error_kind}] after {rec.retries} retries, "
              f"{rec.new_tokens} token(s) — {rec.error}")
    counters = health["counters"]
    print(f"engine health: retries={counters['retries']} "
          f"slot_failures={counters['slot_failures']} "
          f"dead_slots={health['dead_slots']} "
          f"steps={counters['steps']} stalled={health['stalled']}")
    if injector is not None:
        print(f"fault injector: {json.dumps(injector.summary())}")


def _dump_recovery_failure(path, payload):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, default=str)
    print(f"wrote failure report to {path}", file=sys.stderr)


def _crash_recovery_harness(args, cfg, params, run_engine) -> int:
    """Kill the engine mid-run with a seeded process_crash, restore from the
    journal and the snapshots, and check the recovery contract
    (exactly-once terminals; bitwise streams with --parity-check).  Returns
    the exit code."""
    import numpy as np

    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.faults import FaultInjector, FaultSpec, SimulatedCrash
    from repro_torch.serve.journal import (JournalCorruption, JournalWriter,
                                           collate, read_journal)
    from repro_torch.serve.lifecycle import RequestState

    workdir = args.ckpt_dir or tempfile.mkdtemp(prefix="serve_recovery_")
    jpath = args.journal or os.path.join(workdir, "journal.wal")
    report = os.path.join(os.path.dirname(jpath) or ".", "recovery_failure.json")
    snap_dir = os.path.join(workdir, "snapshots")
    snap_every = args.snapshot_every or 4
    rng = np.random.default_rng(args.fault_seed)
    crash_rid = int(rng.integers(0, args.requests))
    spec = FaultSpec(kind="process_crash", phase=args.crash_phase,
                     rid=crash_rid, at_call=args.crash_after)
    print(f"recovery chaos: scheduled process_crash at {args.crash_phase} "
          f"hit {args.crash_after} of rid {crash_rid} "
          f"(seed {args.fault_seed}); journal={jpath} "
          f"snapshots={snap_dir} every {snap_every} steps")

    crashed = None
    journal = JournalWriter(jpath, overwrite=True)
    try:
        run_engine(FaultInjector([spec]), journal=journal,
                   snapshot_dir=snap_dir, snapshot_every=snap_every)
    except SimulatedCrash as e:
        crashed = e
    finally:
        journal.close()  # the dead engine's handle; restore reopens the file
    if crashed is None:
        print(f"RECOVERY CHAOS MISBEHAVED: the crash point was never hit "
              f"(rid {crash_rid} finished in fewer than "
              f"{args.crash_after + 1} {args.crash_phase} calls?)",
              file=sys.stderr)
        return 1
    print(f"engine died as scheduled: {crashed}")

    t0 = time.perf_counter()
    try:
        eng = ServeEngine.restore(cfg, params, jpath, snapshot_dir=snap_dir,
                                  snapshot_every=snap_every,
                                  kernel_impl=args.impl,
                                  max_retries=args.retries,
                                  stall_patience=args.stall_patience,
                                  device=args.device)
        done = eng.run()
        eng.journal.close()
        col = collate(read_journal(jpath).records)
    except JournalCorruption as e:
        print(f"RECOVERY FAILED: {e}", file=sys.stderr)
        _dump_recovery_failure(report, {"error": str(e), "journal": jpath})
        return 1
    dt = time.perf_counter() - t0
    print(f"restored + drained in {dt:.2f}s ({len(done)} records, "
          f"{len(col.recovers)} recover marker(s))")

    problems = []
    # exactly-once termination: collate() above already raised on a double
    # terminal or a non-contiguous token stream; what remains is coverage
    missing = [rid for rid in range(args.requests) if rid not in col.terminals]
    if missing:
        problems.append(f"rids {missing} never reached a journaled terminal")
    not_finished = [r.rid for r in done.values()
                    if r.status is not RequestState.FINISHED]
    if not_finished:
        problems.append(f"rids {not_finished} did not finish cleanly: "
                        f"{[str(done[r].status) for r in not_finished]}")
    for rid, rec in done.items():
        if col.tokens.get(rid, []) != rec.out_tokens:
            problems.append(f"rid {rid}: journal stream != record stream")

    if args.parity_check:
        _, clean = run_engine(None)
        mismatched = [rid for rid in sorted(clean)
                      if done[rid].out_tokens != clean[rid].out_tokens]
        if mismatched:
            problems.append(f"streams for rids {mismatched} are not "
                            f"bitwise equal to the uninterrupted run")
        else:
            print(f"parity OK: all {len(clean)} recovered streams bitwise "
                  f"identical to the uninterrupted run (crash target "
                  f"rid {crash_rid} included)")

    if problems:
        for p in problems:
            print(f"RECOVERY VIOLATION: {p}", file=sys.stderr)
        _dump_recovery_failure(report, {
            "problems": problems, "journal": jpath, "health": eng.health(),
            "records": {rid: {"status": str(r.status), "tokens": r.out_tokens,
                              "error_kind": r.error_kind}
                        for rid, r in sorted(done.items())}})
        return 1
    print(f"recovery chaos OK: {len(done)} requests terminated exactly "
          f"once across the crash")
    return 0


def _parser():
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Serve batched requests through the port on the card.")
    ap.add_argument("--arch", default="smollm-135m")
    width = ap.add_mutually_exclusive_group()
    width.add_argument("--reduced", dest="reduced", action="store_true",
                       default=True,
                       help="the config's reduced form (default)")
    width.add_argument("--full", dest="reduced", action="store_false",
                       help="the config's published widths and depth")
    ap.add_argument("--layers", type=_positive_int, default=None,
                    help="serve the first L layers (a depth cut; a moe "
                         "config keeps at least one MoE layer)")
    ap.add_argument("--quantize", action="store_true",
                    help="W4A4+LRC by RTN + SVD (rank 10%%, clip 0.9)")
    ap.add_argument("--act-group", type=_positive_int, default=None,
                    help="group-wise activation scales for --quantize "
                         "(paper Table 2 g, e.g. 64 or 128)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--page-size", type=_positive_int, default=16,
                    help="paged-KV page granularity in tokens")
    ap.add_argument("--kv-pages", type=_positive_int, default=None,
                    help="pages in the shared KV pool (default: every slot "
                         "at full length, so it never runs dry)")
    ap.add_argument("--prefill-chunk", type=_positive_int, default=None,
                    help="chunked prefill width in tokens (default: the "
                         "whole prompt in one forward)")
    ap.add_argument("--kv-dtype", default="f32",
                    choices=("f32", "bf16", "int8", "int4"),
                    help="KV-cache storage dtype (serve/kvquant.KVSpec)")
    ap.add_argument("--kv-group", type=_positive_int, default=None,
                    help="scale-group size along head_dim for a quantized "
                         "--kv-dtype; default one scale per (token, head)")
    ap.add_argument("--impl", default="auto",
                    choices=("auto", "sim", "int8", "pallas", "fused"),
                    help="QLinear path at serving: auto = the kernel paths "
                         "on the card, the calibrated impl on the CPU")
    # -- request-lifecycle knobs (serve/lifecycle.py) -----------------------
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request deadline in seconds; expired requests "
                         "come back as TIMED_OUT records")
    ap.add_argument("--retries", type=int, default=2,
                    help="retries of a failed attempt before the request is "
                         "FAILED")
    ap.add_argument("--retry-backoff-s", type=float, default=0.0,
                    help="base backoff between retries (doubles per attempt)")
    ap.add_argument("--queue-bound", type=int, default=None,
                    help="admission-queue depth limit; overflow is handled "
                         "per --queue-policy as REJECTED records")
    ap.add_argument("--queue-policy", default="reject_new",
                    choices=("reject_new", "drop_oldest"))
    ap.add_argument("--stall-patience", type=int, default=64,
                    help="steps without progress before the watchdog stops "
                         "run() with a stall report")
    # -- chaos (serve/faults.py) --------------------------------------------
    ap.add_argument("--inject-faults", type=int, default=0, metavar="K",
                    help="target K of the N requests with seeded hard "
                         "faults; the run then checks exactly K "
                         "FAILED/TIMED_OUT + N-K FINISHED records")
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--fault-kinds", default="exception,nan_logits,cache_corruption",
                    help="comma-separated hard fault kinds to sample from")
    ap.add_argument("--fault-phase", default="decode",
                    choices=("prefill", "decode", "sampling"))
    ap.add_argument("--parity-check", action="store_true",
                    help="replay the same requests fault-free and check the "
                         "untargeted (or recovered) streams are bitwise "
                         "identical")
    # -- crash recovery (serve/journal.py + engine snapshot/restore) --------
    ap.add_argument("--journal", default=None, metavar="PATH",
                    help="write-ahead request journal path")
    ap.add_argument("--ckpt-dir", default=None, metavar="DIR",
                    help="engine snapshot directory")
    ap.add_argument("--snapshot-every", type=int, default=0, metavar="N",
                    help="snapshot the engine every N steps; needs --ckpt-dir")
    ap.add_argument("--crash-after", type=int, default=None, metavar="K",
                    help="kill the engine with a seeded process_crash on the "
                         "K-th --crash-phase hit of a seed-picked rid, then "
                         "restore and check every request terminates exactly "
                         "once")
    ap.add_argument("--crash-phase", default="decode",
                    choices=("prefill", "decode", "sampling"))
    return ap


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.crash_after is not None and args.crash_after < 0:
        ap.error("--crash-after must be >= 0")
    if args.crash_after is not None and args.inject_faults:
        ap.error("--crash-after and --inject-faults are separate chaos "
                 "harnesses; pick one")

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models import model as model_lib
    from repro_torch.models.config import reduced as reduce_cfg
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.faults import FaultInjector
    from repro_torch.serve.kvquant import KVSpec
    from repro_torch.serve.lifecycle import Request, RequestState

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    if args.layers is not None:
        if cfg.family == "moe" and args.layers <= cfg.n_dense_layers:
            ap.error(f"--layers {args.layers} keeps no MoE layer of {cfg.name} "
                     f"({cfg.n_dense_layers} dense layer(s) lead)")
        cfg = dataclasses.replace(cfg, n_layers=min(args.layers, cfg.n_layers))
    params = model_lib.init_params(cfg, seed=0, device=device)

    if args.quantize:
        from repro_torch.quant.calibrate import quantize_model
        from repro_torch.quant.policy import QuantPolicy

        params = quantize_model(
            cfg, params, None,
            QuantPolicy(quant_method="rtn", correction="svd", rank_frac=0.10,
                        impl="sim", clip_ratio=0.9, act_group=args.act_group),
            rotate=False)
        print("serving the W4A4+LRC quantized model (RTN + SVD)"
              + (f" (act_group={args.act_group})" if args.act_group else ""))

    injector = None
    if args.inject_faults > 0:
        kinds = tuple(k.strip() for k in args.fault_kinds.split(",") if k.strip())
        injector = FaultInjector.sample(
            range(args.requests), k=args.inject_faults, seed=args.fault_seed,
            kinds=kinds, phase=args.fault_phase,
            repeat=args.retries + 4)  # outlast the retry budget
        print(f"injecting seeded faults (seed {args.fault_seed}) into "
              f"{args.inject_faults}/{args.requests} requests: "
              f"rids {sorted(injector.targets)}")

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 12).astype(np.int32)
               for _ in range(args.requests)]

    kv_spec = KVSpec.from_flags(args.kv_dtype, args.kv_group)
    if kv_spec.is_quantized:
        print(f"KV cache stored as {kv_spec.describe()}")

    def run_engine(inj, **crash_safety):
        eng = ServeEngine(
            cfg, params, batch_slots=args.slots, max_seq=args.max_seq,
            page_size=args.page_size, kv_pages=args.kv_pages,
            prefill_chunk=args.prefill_chunk, kv_spec=kv_spec,
            kernel_impl=args.impl, max_retries=args.retries,
            retry_backoff_s=args.retry_backoff_s,
            queue_limit=args.queue_bound, queue_policy=args.queue_policy,
            default_deadline_s=args.deadline_s,
            stall_patience=args.stall_patience, injector=inj,
            device=device, **crash_safety)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p.copy(),
                               max_new_tokens=args.new_tokens))
        return eng, eng.run()

    if args.crash_after is not None:
        return _crash_recovery_harness(args, cfg, params, run_engine)

    crash_safety = {}
    if args.journal:
        from repro_torch.serve.journal import JournalWriter

        crash_safety["journal"] = JournalWriter(args.journal, overwrite=True)
    if args.ckpt_dir:
        crash_safety.update(snapshot_dir=args.ckpt_dir,
                            snapshot_every=args.snapshot_every)

    t0 = time.perf_counter()
    try:
        eng, done = run_engine(injector, **crash_safety)
    finally:
        if "journal" in crash_safety:
            crash_safety["journal"].close()
    dt = time.perf_counter() - t0
    total = sum(len(r.out_tokens) for r in done.values())
    finished = [r for r in done.values() if r.ok]
    print(f"{len(done)} requests ({len(finished)} finished), {total} tokens, "
          f"{dt:.2f}s -> {total / max(dt, 1e-9):.1f} tok/s on {device}")
    health = eng.health()
    kv = health["kv"]
    what = ("K+V incl. scale planes" if health["mode"] == "paged"
            else "the latent c_kv + k_rope rows")
    print(f"{cfg.name}: {cfg.n_layers} layers, {health['mode']} mode; kv cache: "
          f"{kv['layout']}, {kv['bytes_per_token']} B/token (all layers, {what})")
    _print_failure_summary(done, eng.health(), injector)

    ok = True
    if injector is not None:
        # the acceptance split: exactly K structured failures, N-K clean
        failures = {r.rid for r in done.values()
                    if r.status in (RequestState.FAILED, RequestState.TIMED_OUT)}
        expect = injector.targets
        if failures != expect or len(finished) != args.requests - len(expect):
            print(f"CHAOS MISMATCH: expected failures {sorted(expect)}, "
                  f"got {sorted(failures)} ({len(finished)} finished)",
                  file=sys.stderr)
            ok = False
        else:
            print(f"chaos split OK: {len(expect)} structured failures, "
                  f"{len(finished)} completions, engine exited cleanly")
        if args.parity_check:
            _, clean = run_engine(None)
            mismatched = [rid for rid in sorted(set(done) - expect)
                          if done[rid].out_tokens != clean[rid].out_tokens]
            if mismatched:
                print(f"PARITY MISMATCH for untargeted rids {mismatched}",
                      file=sys.stderr)
                ok = False
            else:
                print(f"parity OK: {len(set(done) - expect)} untargeted "
                      f"requests bitwise identical to the fault-free run")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
