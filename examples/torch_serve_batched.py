"""Serving example on the PyTorch/CUDA port: batched greedy decoding on the
xLSTM (O(1)-state) architecture — the family where long-context decode is
native (the port's ``examples/serve_batched.py``).

Run:  PYTHONPATH=src python examples/torch_serve_batched.py [--device cpu]

Runs on the card unless ``--device cpu`` is given; with no CUDA device and
no ``--device cpu`` the example raises.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.serve.engine import DecodeEngine, Request


def serve(cfg, params, device) -> list[Request]:
    """4 seeded requests of 6 tokens, 12 new tokens each, on one engine."""
    eng = DecodeEngine(cfg, params, batch_size=4, cache_len=256,
                       device=device)
    rng = np.random.default_rng(0)
    reqs = [
        Request(rng.integers(0, cfg.vocab_size, 6).astype(np.int32),
                max_new_tokens=12)
        for _ in range(4)
    ]
    t0 = time.time()
    out = eng.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    tok = sum(len(r.out) for r in out)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "CPU")
    print(f"{tok} tokens in {dt:.2f}s ({tok/dt:.1f} tok/s, {name})")
    for i, r in enumerate(out):
        print(f"req{i}: {list(r.prompt)} -> {r.out}")
    assert all(len(r.out) == 12 for r in out)
    print("OK")
    return out


def main(argv=None) -> list[Request]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="cuda (the default) or "
                    "cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config("xlstm-1.3b").reduced()
    params = build_model(cfg).init(0, device=device)
    return serve(cfg, params, device)


if __name__ == "__main__":
    main()
