"""End-to-end example on the PyTorch/CUDA port: train a reduced TinyLlama
for a few hundred steps, checkpoint, restore, serve (the port's
``examples/train_tinyllama.py``).

Run:  PYTHONPATH=src python examples/torch_train_tinyllama.py [--device cpu]

Runs on the card unless ``--device cpu`` is given; with no CUDA device and
no ``--device cpu`` the example raises.
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np

from repro_torch.ckpt.checkpoint import restore_checkpoint
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.serve.engine import DecodeEngine, Request
from repro_torch.train.loop import train
from repro_torch.train.optimizer import OptimizerConfig

STEPS = 200


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="cuda (the default) or "
                    "cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("tinyllama-1.1b").reduced()
    shape = ShapeConfig("example", seq_len=64, global_batch=8, kind="train")

    with tempfile.TemporaryDirectory() as ckpt_dir:
        res = train(
            cfg,
            shape,
            steps=STEPS,
            ocfg=OptimizerConfig(peak_lr=3e-3, warmup_steps=10,
                                 decay_steps=STEPS),
            checkpoint_dir=ckpt_dir,
            checkpoint_every=100,
            log_every=25,
            device=device,
        )
        first, last = res["history"][0]["loss"], res["history"][-1]["loss"]
        print(f"loss {first:.3f} -> {last:.3f}")
        assert last < first - 0.5, "training failed to learn"

        state, step = restore_checkpoint(ckpt_dir, res["state"])
        print(f"restored checkpoint at step {step}")
        # Steps count from 0: the checkpoint after the last step is 199.
        assert step == STEPS - 1, step

    eng = DecodeEngine(cfg, res["state"]["params"], batch_size=2,
                       cache_len=128, device=device)
    reqs = [Request(np.asarray([5, 7, 9], np.int32), max_new_tokens=8)
            for _ in range(2)]
    for i, r in enumerate(eng.run(reqs)):
        print(f"req{i} -> {r.out}")
    print("OK")
    return res


if __name__ == "__main__":
    main()
