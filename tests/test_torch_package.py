"""Package hygiene of the PyTorch port, and chip_smoke's serving phases at
a tiny size on the CPU.

The port and chip_smoke.py import neither ``jax`` nor ``repro`` (the
card's machine has no JAX); entry points refuse to run on the CPU unless
asked to.
"""
import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

_HYGIENE = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {repo!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke  # noqa: F401
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
assert not bad, bad
"""


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    code = _HYGIENE.format(src=str(REPO / "src"), repo=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(maxsplit=1)
    assert int(n) >= 15 and bad.strip() == "[]"


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    from repro_torch.core.t2drl import T2DRLCfg, policy_init
    from repro_torch.device import make_generator, resolve_device
    from repro_torch.serving import EdgeGateway
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (resolve_device, lambda: resolve_device("cuda"),
                 lambda: make_generator(0),
                 lambda: policy_init(T2DRLCfg(), 0),
                 lambda: EdgeGateway([], 1.0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrapper_has_no_fallback_for_other_devices():
    from repro_torch.kernels import ops
    x = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.ddpm_step(x, x, x, 0.9, 0.5, 0.04, 1)


def test_build_targets_sm90a_and_the_ignored_build_dir():
    from repro_torch.kernels import build
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert build.sources() == ["ddpm_step"]
    assert build.BUILD_DIR == REPO / "build" / "torch_kernels"
    assert "build/" in (REPO / ".gitignore").read_text().split()
    assert build.library_path("ddpm_step").parent == build.BUILD_DIR


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_serving_phases_run_small_on_cpu():
    cs = _chip_smoke()
    from repro_torch.core.env import EnvCfg
    cfg = EnvCfg(U=4, M=4, T=2, K=2)
    ctrl = cs.phase_control_plane("cpu", cfg, episodes=1)
    assert ctrl["expected_launches"] == 5 * 2 * 2
    assert ctrl["ddpm_step_launches"] == 0          # CPU: plain version only
    assert ctrl["slot_kernel_vs_plain_max_abs_err"] <= 2e-5
    data = cs.phase_data_plane("cpu", cfg, image_dim=16, total_steps=20)
    assert len(data["slots"]) == 4 and data["ddpm_step_launches"] == 0
    assert data["expected_launches"] == 5 * 4 + data["image_steps"]


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(extra)
    return env


def test_chip_smoke_refuses_to_run_without_a_card():
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         env=_env(CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and '"ok"' not in out.stdout
    assert "no CUDA device" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=_env())
    assert out.returncode != 0 and out.stdout == ""


def test_bound_is_bytes_at_serving_shapes():
    cs = _chip_smoke()
    ms, by = cs.ddpm_bound_ms(256, 4)
    assert by == "bytes" and ms == pytest.approx(1e3 * 16 * 256 / 3.35e12)
