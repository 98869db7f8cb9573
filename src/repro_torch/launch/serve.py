"""Serving launcher: batched greedy decoding with the reduced model.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --prompts 4 --new-tokens 16 [--device cpu]

``--arch`` takes every family: dense, MoE (``deepseek-v2-lite-16b``,
``arctic-480b``), VLM (``internvl2-76b``, served on text), audio, hybrid
(``jamba-1.5-large-398b``) and SSM (``xlstm-1.3b``).
An encoder-decoder (``seamless-m4t-large-v2``) first runs its encoder
over 16 zero frames (``prefill_cross``), as the reference's launcher does.

Port of ``repro.launch.serve``: the same flags and the same ``.reduced()``
model, plus ``--device`` (default ``cuda``; with no CUDA device the
launcher raises unless ``--device cpu`` is given).  ``--overlap-mode
ficco_autotune`` resolves each overlapped projection through the
runtime tuner (:mod:`repro_torch.autotune`).

``--adapt`` additionally runs the online-adaptation tier
(:mod:`repro_torch.serve.adapt`): a bounded in-memory decision cache over
the persistent store (``autotune-torch-v2.json`` under
``$REPRO_AUTOTUNE_CACHE_DIR``), a background re-fit thread (its machine
fit on ``--device``), and the exploration-budget measured tier.  Knobs:
``--adapt-cache-size``, ``--adapt-ttl``, ``--adapt-refit-s``,
``--adapt-explore-rate``, ``--adapt-no-sentinel``.  ``--signatures PATH``
streams per-decision inefficiency signatures to a JSONL file
(:mod:`repro_torch.obs.signature`).
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
    ap.add_argument(
        "--adapt", action="store_true",
        help="enable the online-adaptation tier (repro_torch.serve.adapt)",
    )
    ap.add_argument("--adapt-cache-size", type=int, default=4096,
                    help="in-memory decision cache bound (LRU beyond)")
    ap.add_argument("--adapt-ttl", type=float, default=300.0,
                    help="decision TTL seconds (expiry forces a re-rank)")
    ap.add_argument("--adapt-refit-s", type=float, default=2.0,
                    help="background re-fit cadence seconds")
    ap.add_argument("--adapt-explore-rate", type=float, default=1.0,
                    help="measured-tier token-bucket refill (sessions/s)")
    ap.add_argument("--adapt-no-sentinel", action="store_true",
                    help="disable the drift sentinel "
                    "(repro_torch.obs.sentinel)")
    ap.add_argument("--signatures", metavar="PATH", default=None,
                    help="stream per-decision inefficiency signatures to "
                    "this JSONL path (repro_torch.obs.signature)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.signatures:
        from repro_torch.obs import signature as _signature

        _signature.enable_signatures(args.signatures)

    cfg = get_config(args.arch).reduced()
    if args.overlap_mode != "gspmd_serial":
        cfg = dataclasses.replace(
            cfg,
            overlap=dataclasses.replace(cfg.overlap, mode=args.overlap_mode),
        )
    model = build_model(cfg)
    state = model.init(0, device=device)
    enc_len = 16 if cfg.encdec else 0
    tier = None
    if args.adapt:
        from repro_torch.serve.adapt import AdaptConfig, AdaptiveTier

        tier = AdaptiveTier(
            config=AdaptConfig(
                cache_size=args.adapt_cache_size,
                ttl_s=args.adapt_ttl,
                refit_interval_s=args.adapt_refit_s,
                explore_rate=args.adapt_explore_rate,
                sentinel=not args.adapt_no_sentinel,
            ),
            device=device,
        ).start()
    eng = DecodeEngine(
        cfg, state, batch_size=args.prompts, cache_len=args.cache_len,
        enc_len=enc_len, device=device, adapt=tier,
    )
    if cfg.encdec:
        eng.encode(torch.zeros((args.prompts, enc_len, cfg.d_model),
                               device=device))
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
    if tier is not None:
        dec = eng.last_decision
        sched = dec.schedule.value if dec is not None else "-"
        print(f"adapt: schedule={sched} stats={tier.stats()}")
        tier.stop()
    if args.signatures:
        from repro_torch.obs import signature as _signature

        stream = _signature.get_signatures()
        if stream is not None:
            snap = stream.export_jsonl()
            print(
                f"signatures: {len(snap['cells'])} cells "
                f"-> {args.signatures}"
            )
    for i, r in enumerate(out):
        print(f"req{i}: {list(r.prompt)} -> {r.out}")


if __name__ == "__main__":
    main()
