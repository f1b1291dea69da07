"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
into ``build/torch_kernels/lib<name>-<hash>.so`` under the repository root
(listed in ``.gitignore``), at first use, for ``sm_90a``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so <name>.cu

The hash covers the source and the flags, so an edited source is rebuilt
and a stale library is never loaded.  ``build_all`` starts one ``nvcc``
per source at once and waits for all of them.  Each library built (not
one found up to date) is one ``repro_torch.obs.profiling.record_compile``
event, tag ``"nvcc:<name>"``.  Libraries are loaded with ``ctypes``; the
wrappers in ``ops.py`` declare each function's argument types.  Nothing
here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

from repro_torch.obs.profiling import record_compile

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def sources() -> list:
    """Kernel names, one per ``csrc/*.cu``."""
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``.  Raises if none is found."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built on the machine that has the card")
    return found


def library_path(name: str) -> Path:
    src = SRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every named source (default: all of ``csrc/``) that has no
    up-to-date library, one ``nvcc`` each, all started together.

    Returns ``{name: {"path", "seconds", "log", "cached"}}`` where ``log``
    is the compiler's output (``-Xptxas -v``: registers, spills).  Raises
    ``RuntimeError`` with the log if any build fails."""
    names = list(sources() if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = nvcc()
    jobs, out = {}, {}
    for name in names:
        path = library_path(name)
        if path.is_file():
            out[name] = {"path": str(path), "seconds": 0.0, "log": "",
                         "cached": True}
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [cmd, *NVCC_FLAGS, "-o", tmp, str(SRC_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, path, time.perf_counter())
    failed = []
    for name, (proc, tmp, path, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)      # atomic: concurrent builds agree
        record_compile(f"nvcc:{name}", path.name)
        out[name] = {"path": str(path), "seconds": seconds, "log": log,
                     "cached": False}
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = library_path(name)
        if not path.is_file():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _LOADED[name] = lib
    return lib
