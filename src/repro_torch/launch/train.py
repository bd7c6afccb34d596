"""Training launcher of the port (counterpart of ``repro/launch/train.py``,
its single-host path).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --steps 100 --batch 16 --seq 128 [--reduced | --full] [--lr 3e-4] \\
        [--ckpt-dir DIR] [--microbatches N] [--device cpu]

The model is the config's reduced form by default (``--full``: its
published widths and depth), random weights from seed 0, trained on the
synthetic corpus (``data/loader.batches``) by ``train/trainer.train``,
resuming from the latest checkpoint under ``--ckpt-dir``.  Both ported
families train: a dense arch on the next-token CE, a moe arch
(``deepseek-v2-236b``, ``deepseek-v3-671b``) on the same CE plus, for V3,
the MTP term (``models/model.loss_fn``).  Everything runs on ``--device``
(``cuda`` by default, which raises without a card).

Not here yet: ``--devices`` / ``--mesh`` (the reference's sharded step on a
data × model mesh waits for the port's ``torch.distributed`` layer, ROADMAP
Queue 1 item 6); they raise.
"""

import argparse
import sys


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--devices", type=int, default=0)
    ap.add_argument("--mesh", default=None, help="e.g. 4x2 (data x model)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.devices or args.mesh:
        raise NotImplementedError(
            "--devices / --mesh (sharded training on a data x model mesh) are "
            "not ported yet: they wait for the port's torch.distributed layer "
            "(ROADMAP Queue 1 item 6)")

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models.config import reduced as reduce_cfg
    from repro_torch.train.trainer import train

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    _, history, watchdog = train(cfg, steps=args.steps, global_batch=args.batch,
                                 seq_len=args.seq, lr=args.lr,
                                 ckpt_dir=args.ckpt_dir,
                                 microbatches=args.microbatches, device=device)
    if history:
        print(f"{len(history)} steps, loss {history[0]:.4f} -> {history[-1]:.4f}, "
              f"median step {watchdog.p50 * 1e3:.1f} ms on {device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
