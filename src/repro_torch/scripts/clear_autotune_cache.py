"""Wipe the port's persistent autotune decision cache (port of the
reference's ``scripts/clear_autotune_cache.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.scripts.clear_autotune_cache \\
      [--dir PATH] [-n]

By default clears :func:`repro_torch.autotune.cache.default_cache_dir`
(``$REPRO_AUTOTUNE_CACHE_DIR``, or ``~/.cache/repro_autotune``).  ``-n`` /
``--dry-run`` only reports what would be removed.  Only the port's store,
``autotune-torch-v*.json``, is touched — the directory itself and anything
else in it (the decision-audit log ``decisions-torch.jsonl``, the
signature stream ``signatures-torch.jsonl``, the reference's own
``autotune-v*.json``) is left alone.  The version glob catches every
schema generation, so orphaned stores from before a schema bump are
cleaned up too.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from repro_torch.autotune.cache import default_cache_dir

STORE_GLOB = "autotune-torch-v*.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.scripts.clear_autotune_cache",
        description=__doc__,
    )
    ap.add_argument(
        "--dir", default=None,
        help="cache directory (default: $REPRO_AUTOTUNE_CACHE_DIR or "
        "~/.cache/repro_autotune)",
    )
    ap.add_argument(
        "-n", "--dry-run", action="store_true",
        help="report what would be removed without removing it",
    )
    args = ap.parse_args(argv)

    cache_dir = args.dir if args.dir is not None else default_cache_dir()
    pattern = os.path.join(cache_dir, STORE_GLOB)
    files = sorted(glob.glob(pattern))
    if not files:
        print(f"nothing to clear: no cache files match {pattern}")
        return 0
    for path in files:
        entries = "?"
        try:
            with open(path) as f:
                raw = json.load(f)
            entries = len(raw.get("entries", {}))
        except (OSError, ValueError):
            pass
        if args.dry_run:
            print(f"would remove {path} ({entries} entries)")
        else:
            os.unlink(path)
            print(f"removed {path} ({entries} entries)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
