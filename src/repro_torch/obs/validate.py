"""CLI schema validator for repro-obs JSONL run logs.

Usage::

    PYTHONPATH=src python -m repro_torch.obs.validate run.jsonl [...]

Exits non-zero (with the offending file:line) on the first invalid
record; prints a per-file record count otherwise.
"""
from __future__ import annotations

import argparse
import sys

from .writer import validate_jsonl


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Validate repro-obs JSONL run logs against the schema.")
    ap.add_argument("paths", nargs="+", help="JSONL run logs to validate")
    args = ap.parse_args(argv)
    rc = 0
    for path in args.paths:
        try:
            n = validate_jsonl(path)
        except (OSError, ValueError) as e:
            print(f"FAIL {e}", file=sys.stderr)
            rc = 1
        else:
            print(f"ok {path}: {n} records")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
