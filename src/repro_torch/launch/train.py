"""Training launcher: train the reduced variant for a few hundred steps.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
      --steps 200 [--overlap-mode ficco_auto] [--ckpt-dir DIR] [--device cpu]

Port of ``repro.launch.train``: the same flags and the same ``.reduced()``
model (``--full-size`` for the full one) of every family: dense, MoE
(``deepseek-v2-lite-16b``, ``arctic-480b``), VLM, audio, hybrid
(``jamba-1.5-large-398b``) and SSM (``xlstm-1.3b``), plus ``--device``
(default ``cuda``; with no CUDA device the launcher raises unless
``--device cpu`` is given).  The reference's docstring names a
``--dry-run`` mode that its argument parser does not have; the dry-run is
``python -m repro_torch.launch.dryrun`` (:mod:`repro_torch.launch.dryrun`).
As in the reference, the loop runs outside any tensor-parallel group, so
``--overlap-mode`` takes effect only for a caller that wraps
:func:`~repro_torch.train.loop.train` in ``tp_group(TPGroup(g))``.
"""

from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.train.loop import train
from repro_torch.train.optimizer import OptimizerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument(
        "--overlap-mode", default="gspmd_serial",
        help="gspmd_serial | serial | shard_p2p | ficco_auto | "
        "explicit schedule value",
    )
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--full-size", action="store_true",
                    help="use the full (non-reduced) config")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_size:
        cfg = cfg.reduced()
    if args.overlap_mode != "gspmd_serial":
        cfg = dataclasses.replace(
            cfg,
            overlap=dataclasses.replace(cfg.overlap, mode=args.overlap_mode),
        )
    shape = ShapeConfig("cli", args.seq_len, args.batch, "train")
    ocfg = OptimizerConfig(
        peak_lr=args.lr,
        warmup_steps=max(args.steps // 20, 5),
        decay_steps=args.steps,
    )
    res = train(
        cfg,
        shape,
        steps=args.steps,
        ocfg=ocfg,
        checkpoint_dir=args.ckpt_dir,
        checkpoint_every=args.ckpt_every,
        device=device,
    )
    first, last = res["history"][0]["loss"], res["history"][-1]["loss"]
    print(f"done: loss {first:.4f} -> {last:.4f}")
    return res


if __name__ == "__main__":
    main()
