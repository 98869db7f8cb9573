"""Serving launcher: batched greedy decoding with the reduced model.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --prompts 4 --new-tokens 16 [--device cpu]

``--arch`` takes the dense and MoE families (``deepseek-v2-lite-16b``,
``arctic-480b``); the others raise until their slice is ported.

Port of ``repro.launch.serve``: the same flags and the same ``.reduced()``
model, plus ``--device`` (default ``cuda``; with no CUDA device the
launcher raises unless ``--device cpu`` is given).  ``--overlap-mode
ficco_autotune`` resolves each overlapped projection through the
runtime tuner (:mod:`repro_torch.autotune`).  The reference's
``--adapt*`` and ``--signatures`` flags wait for the serving tier
(ROADMAP A4 step 3).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.serve.engine import DecodeEngine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--prompts", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument(
        "--overlap-mode", default="gspmd_serial",
        help="gspmd_serial | serial | shard_p2p | ficco_auto | "
        "ficco_autotune | explicit schedule value",
    )
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    if args.overlap_mode != "gspmd_serial":
        cfg = dataclasses.replace(
            cfg,
            overlap=dataclasses.replace(cfg.overlap, mode=args.overlap_mode),
        )
    model = build_model(cfg)
    state = model.init(0, device=device)
    eng = DecodeEngine(
        cfg, state, batch_size=args.prompts, cache_len=args.cache_len,
        device=device,
    )
    rng = np.random.default_rng(0)
    reqs = [
        Request(
            rng.integers(0, cfg.vocab_size, args.prompt_len).astype(np.int32),
            max_new_tokens=args.new_tokens,
        )
        for _ in range(args.prompts)
    ]
    t0 = time.time()
    out = eng.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    total = sum(len(r.out) for r in out)
    name = (
        torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    )
    print(f"decoded {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s on {name})")
    for i, r in enumerate(out):
        print(f"req{i}: {list(r.prompt)} -> {r.out}")


if __name__ == "__main__":
    main()
