"""LRC calibration launcher of the port (counterpart of
``repro/launch/quantize.py``): quantize a model W4A4 + low-rank and write
the quantized params as a checkpoint.

    PYTHONPATH=src python -m repro_torch.launch.quantize --arch smollm-135m \\
        [--full [--layers L]] [--rank-frac 0.10] [--iters 1] \\
        [--method gptq|rtn] [--correction lrc|svd|none] [--act-group G] \\
        [--ckpt DIR] [--out results/quantized] [--resume-dir DIR] \\
        [--calib-seqs 24] [--calib-len 96] [--device cpu]

The model is the config's reduced form by default (``--full``: its
published widths and depth; ``--layers L`` keeps its first L layers), with
random weights from seed 0, or the params of ``--ckpt`` (a step directory
written by ``checkpoint/ckpt.save_checkpoint`` holding the model's params
tree, as ``bench/common.py`` writes its trained model).  Calibration runs
the paper's pipeline (``quant/calibrate.quantize_model``: QuaRot's
rotation, the statistics walk on ``--calib-seqs`` synthetic sequences of
``--calib-len`` tokens, GPTQ or RTN, LRC), printing each layer as it is
done, with QLinears of impl ``sim`` as in the reference.  The result is
written with ``save_checkpoint`` to ``<--out>/step_00000000`` and loads
back through ``load_checkpoint(path, like=quantize_shell.quantized_param_shapes(
cfg, policy, rotated=True), device=...)``; ``qlinear.retag_qlinear_impl``
then picks the serving path.  Everything runs on ``--device`` (``cuda`` by
default, which raises without a card; on the card the walk's attention
runs kernel #7).
"""

import argparse
import dataclasses
import sys

from repro_torch.launch.serve import _positive_int


def _parser():
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.quantize",
        description="Quantize a model W4A4 + LRC and write its checkpoint.")
    ap.add_argument("--arch", default="smollm-135m")
    width = ap.add_mutually_exclusive_group()
    width.add_argument("--reduced", dest="reduced", action="store_true", default=True,
                       help="the config's reduced form (default)")
    width.add_argument("--full", dest="reduced", action="store_false",
                       help="the config's published widths and depth")
    ap.add_argument("--layers", type=_positive_int, default=None,
                    help="quantize the first L layers (a depth cut; a moe "
                         "config keeps at least one MoE layer)")
    ap.add_argument("--rank-frac", type=float, default=0.10)
    ap.add_argument("--iters", type=int, default=1)
    ap.add_argument("--method", default="gptq", choices=["gptq", "rtn"])
    ap.add_argument("--correction", default="lrc", choices=["lrc", "svd", "none"])
    ap.add_argument("--act-group", type=int, default=0)
    ap.add_argument("--ckpt", default=None, help="model checkpoint to load")
    ap.add_argument("--out", default="results/quantized")
    ap.add_argument("--resume-dir", default=None,
                    help="per-layer calibration resume directory")
    ap.add_argument("--calib-seqs", type=int, default=24)
    ap.add_argument("--calib-len", type=int, default=96)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def quantize(argv=None):
    """The launcher's work without the exit code: returns ``(cfg, policy,
    the quantized params as calibrated, the checkpoint's path)``."""
    ap = _parser()
    args = ap.parse_args(argv)

    from repro_torch.checkpoint.ckpt import load_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data.loader import calib_sequences
    from repro_torch.device import resolve_device
    from repro_torch.models import model as model_lib
    from repro_torch.models.config import reduced as reduce_cfg
    from repro_torch.quant.calibrate import quantize_model
    from repro_torch.quant.policy import QuantPolicy
    from repro_torch.quant.shell import param_shapes

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    if args.layers is not None:
        if cfg.family == "moe" and args.layers <= cfg.n_dense_layers:
            ap.error(f"--layers {args.layers} keeps no MoE layer of {cfg.name} "
                     f"({cfg.n_dense_layers} dense layer(s) lead)")
        cfg = dataclasses.replace(cfg, n_layers=min(args.layers, cfg.n_layers))
    if args.ckpt:
        params = load_checkpoint(args.ckpt, param_shapes(cfg), device=device)
    else:
        params = model_lib.init_params(cfg, seed=0, device=device)

    calib = calib_sequences(cfg, n_seq=args.calib_seqs, seq_len=args.calib_len,
                            device=device)
    policy = QuantPolicy(
        bits=4, act_bits=4, rank_frac=args.rank_frac,
        act_group=args.act_group or None, impl="sim",
        lrc_iters=args.iters, quant_method=args.method,
        correction=args.correction,
    )

    def progress(done, total):
        print(f"  layer {done + 1 if isinstance(done, int) else done}/{total}",
              flush=True)

    qparams = quantize_model(cfg, params, calib, policy,
                             resume_dir=args.resume_dir, progress=progress)
    path = save_checkpoint(args.out, 0, qparams)
    print(f"quantized params saved to {path}")
    return cfg, policy, qparams, path


def main(argv=None) -> int:
    quantize(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
