"""Structured emission (DESIGN.md §15), port of ``repro.obs.writer``:
schema-versioned JSONL records and run manifests.

Records are append-only JSON objects, one per line, stamped ``{"schema":
"repro-obs/1", "kind": <kind>, ...}`` and checked against the per-kind
required fields when written, so schema drift fails at the producer.  A
run log starts with a ``manifest`` (:func:`run_manifest`: config hash,
seed, git sha, framework and device), which :func:`validate_jsonl`
requires (CLI: ``python -m repro_torch.obs.validate``).  The schema and
its required fields are the JAX package's, so either package's validator
accepts the other's logs: the port's manifest carries ``"jax": null``
beside ``"torch"``, its ``backend`` is ``"cuda"`` or ``"cpu"`` and its
``device_kind`` the card's name.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import platform
import subprocess
import sys
import time

import numpy as np
import torch

SCHEMA = "repro-obs/1"

# Required fields per record kind (beyond "schema"/"kind"); extra fields
# are always allowed.
REQUIRED_FIELDS = {
    "manifest": ("run_id", "created_unix", "jax", "backend", "device_kind",
                 "cfg_hash"),
    "train_chunk": ("episode", "episodes", "wall_s", "stats"),
    "eval": ("metrics",),
    "fleet_frame": ("frame", "p50_s", "p95_s", "p99_s", "drop_rate",
                    "slo_viol_rate", "mean_backlog_s"),
    "fleet_summary": ("metrics",),
    "profile": ("stage", "wall_s"),
}


def to_jsonable(x):
    """Tensors, arrays, numpy scalars and dataclasses as plain JSON
    values."""
    if isinstance(x, dict):
        return {str(k): to_jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [to_jsonable(v) for v in x]
    if isinstance(x, (str, bool, int, float)) or x is None:
        return x
    if isinstance(x, np.bool_):
        return bool(x)
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.floating):
        return float(x)
    if torch.is_tensor(x):
        return to_jsonable(x.detach().cpu().tolist())
    if hasattr(x, "tolist"):
        return to_jsonable(np.asarray(x).tolist())
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return repr(x)
    return str(x)


def cfg_hash(cfg) -> str:
    """Short stable hash of a frozen-dataclass config (its repr, nested
    configs included)."""
    return hashlib.sha256(repr(cfg).encode()).hexdigest()[:16]


def _git_sha():
    try:
        here = os.path.dirname(os.path.abspath(__file__))
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=here,
                             capture_output=True, text=True, timeout=5)
    except (OSError, subprocess.SubprocessError):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else None


def run_manifest(cfg=None, extra=None, device=None) -> dict:
    """The run-manifest record: git sha, the torch and CUDA versions, the
    device the run uses (``resolve_device(device)``: the card unless
    ``"cpu"`` is asked for) with its kind and count, the config's hash,
    repr and seed.  ``"jax"`` is null: the port runs no JAX."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    rec = {
        "schema": SCHEMA,
        "kind": "manifest",
        "run_id": f"{int(time.time() * 1e3):x}-{os.getpid():x}",
        "created_unix": time.time(),
        "argv": list(sys.argv),
        "python": platform.python_version(),
        "jax": None,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "backend": dev.type,
        "device_kind": (torch.cuda.get_device_name(dev) if cuda
                        else platform.machine() or "cpu"),
        "device_count": torch.cuda.device_count() if cuda else 1,
        "cpu_count": os.cpu_count(),
        "git_sha": _git_sha(),
        "cfg_hash": cfg_hash(cfg) if cfg is not None else None,
    }
    if cfg is not None:
        rec["cfg"] = repr(cfg)
        rec["seed"] = getattr(cfg, "seed", None)
    if extra:
        rec.update(to_jsonable(extra))
    return rec


def progress_line(episode: int, last: dict) -> str:
    """The per-chunk progress line, the reference's format."""
    return (f"ep {episode:4d} reward {last['episode_reward']:9.2f} "
            f"hit {last['hit_ratio']:.3f} "
            f"G {last['utility']:7.2f}")


def validate_record(rec) -> None:
    """Raise ``ValueError`` unless ``rec`` is a schema-valid record."""
    if not isinstance(rec, dict):
        raise ValueError(f"record must be a JSON object, got {type(rec)}")
    if rec.get("schema") != SCHEMA:
        raise ValueError(f"unknown schema {rec.get('schema')!r}; "
                         f"expected {SCHEMA!r}")
    kind = rec.get("kind")
    if kind not in REQUIRED_FIELDS:
        raise ValueError(f"unknown record kind {kind!r}; expected one of "
                         f"{sorted(REQUIRED_FIELDS)}")
    missing = [f for f in REQUIRED_FIELDS[kind] if f not in rec]
    if missing:
        raise ValueError(f"{kind!r} record is missing required fields "
                         f"{missing}")


def validate_jsonl(path) -> int:
    """Validate a JSONL run log: every line a schema-valid record, the
    first a ``manifest``.  Returns the record count; raises ``ValueError``
    with the offending line number."""
    n = 0
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno}: invalid JSON: {e}")
            try:
                validate_record(rec)
            except ValueError as e:
                raise ValueError(f"{path}:{lineno}: {e}")
            if n == 0 and rec["kind"] != "manifest":
                raise ValueError(f"{path}:{lineno}: first record must be a "
                                 f"manifest, got {rec['kind']!r}")
            n += 1
    if n == 0:
        raise ValueError(f"{path}: empty run log")
    return n


class MetricWriter:
    """Append-only schema-versioned JSONL sink: records are validated when
    written and flushed line by line.  ``ensure_manifest`` stamps the
    manifest once, so a caller that opened the writer and stamped it can
    hand it to ``train_t2drl``."""

    def __init__(self, path, *, mode: str = "w"):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self.path = path
        self._f = open(path, mode)
        self._wrote_manifest = False

    def write(self, kind: str, **fields) -> dict:
        rec = {"schema": SCHEMA, "kind": kind}
        rec.update(to_jsonable(fields))
        validate_record(rec)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        return rec

    def manifest(self, cfg=None, extra=None, device=None) -> dict:
        rec = run_manifest(cfg=cfg, extra=extra, device=device)
        validate_record(rec)
        self._f.write(json.dumps(to_jsonable(rec)) + "\n")
        self._f.flush()
        self._wrote_manifest = True
        return rec

    def ensure_manifest(self, cfg=None, extra=None, device=None):
        if not self._wrote_manifest:
            self.manifest(cfg=cfg, extra=extra, device=device)

    def close(self):
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
