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
    assert int(n) >= 35 and bad.strip() == "[]"


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    from repro_torch.core.t2drl import T2DRLCfg, policy_init
    from repro_torch.device import make_generator, resolve_device
    from repro_torch.serving import EdgeGateway
    from repro_torch.bridge import lm_params_from_numpy
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve_demo
    from repro_torch.serving import Engine, ServeCfg
    cfg = get_arch("qwen2-0.5b").make_smoke()
    cs = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (resolve_device, lambda: resolve_device("cuda"),
                 lambda: make_generator(0),
                 lambda: policy_init(T2DRLCfg(), 0),
                 lambda: EdgeGateway([], 1.0),
                 lambda: Engine(cfg, {}, ServeCfg()),
                 lambda: serve_demo("qwen2-0.5b"),
                 lambda: lm_params_from_numpy({}, cfg),
                 lambda: cs.phase_lm_plane(None, make="make_smoke")):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrapper_has_no_fallback_for_other_devices():
    from repro_torch.kernels import ops
    x = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.ddpm_step(x, x, x, 0.9, 0.5, 0.04, 1)
    q = torch.zeros(1, 8, 2, 32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.flash_attention(q, q, q)
    x, dt, h = (torch.zeros(s, device="meta") for s in
                ((1, 8, 2, 4), (1, 8, 2), (2,)))
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.ssd_scan(x, dt, h, x, x, h)


def test_build_targets_sm90a_and_the_ignored_build_dir():
    from repro_torch.kernels import build
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert build.sources() == ["ddpm_chain", "ddpm_step", "flash_attention",
                               "ssd_scan"]
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
    assert ctrl["expected_launches"] == 2 * 2       # one chain per slot
    # CPU: plain versions only, no launch
    assert ctrl["launches"] == {"ddpm_chain": 0, "ddpm_step": 0}
    assert ctrl["slot_kernel_vs_plain_max_abs_err"] <= 2e-5
    episode = ctrl["chain_vs_step_episode"]
    assert episode["slots"] == 4 and episode["actions_max_abs_diff"] <= 2e-5
    data = cs.phase_data_plane("cpu", cfg, image_dim=16, total_steps=20)
    assert len(data["slots"]) == 4
    assert data["launches"] == {"ddpm_chain": 0, "ddpm_step": 0}
    # the actor's chain per slot and one per served image
    assert data["expected_launches"] == {"ddpm_chain": 4 + data["images"],
                                         "ddpm_step": 0}
    assert 1 <= data["images"] <= data["image_steps"]


def test_chip_smoke_train_phase_runs_small_on_cpu():
    """The train phase at a small env on the CPU: the gates' update counts,
    parameters changed, finite losses, eval and the short runs; no launch
    on the CPU, the launches the card must make computed all the same."""
    cs = _chip_smoke()
    from repro_torch.core.env import EnvCfg
    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # small ops: extra threads only contend
    try:
        tr = cs.phase_train("cpu", EnvCfg(U=3, M=4, T=10, K=4), episodes=5,
                            short=1, eval_episodes=1)
    finally:
        torch.set_num_threads(threads)
    # 40 slots an episode, warmup 100: 5 frames of 4 updates in episode 3,
    # then 40 an episode; 9 frame transitions an episode, past the DDQN
    # batch of 32 from the 33rd on
    assert tr["d3pg_updates"] == 20 + 40 + 40 and tr["ddqn_updates"] == 4 + 9
    assert tr["launches"] == {"ddpm_chain": 0, "ddpm_chain_bwd": 0,
                              "ddpm_step": 0, "ddpm_step_bwd": 0}
    n = tr["d3pg_updates"]
    # acting, then each update's target chain and its policy chain with
    # the record, whose gradient is one ddpm_chain_bwd
    assert tr["expected_launches"] == {"ddpm_chain": 5 * 40 + 2 * n,
                                       "ddpm_chain_bwd": n,
                                       "ddpm_step": 0, "ddpm_step_bwd": 0}
    upd = tr["update_timing"]
    assert set(upd) == {"updates", "chain", "step"}
    for impl in ("chain", "step"):
        assert upd[impl]["ms_per_update"] > 0
        assert sum(upd[impl]["launches"].values()) == 0     # CPU
    assert cs.update_launches("step", 5, 50) == {
        "ddpm_chain": 50, "ddpm_chain_bwd": 0, "ddpm_step": 250,
        "ddpm_step_bwd": 250}
    assert set(tr["short_runs"]) == {"ddpg/ddqn", "rcars/static"}
    assert tr["short_runs"]["rcars/static"]["d3pg_updates"] == 0
    # the paper's cell: no update in episode 1, 100 a slot after; DDQN
    # from episode 4 on
    assert cs.predicted_updates(cs.method_cfg("d3pg", "ddqn", EnvCfg(), 8),
                                8) == [(0, 0)] + [(100, 0)] * 2 + \
        [(100, 4)] + [(100, 9)] * 4


def test_chip_smoke_lm_plane_runs_small_on_cpu():
    """The LM plane at smoke widths: both engines behind the gateway, the
    expected launch counts (none run on the CPU), kernel vs plain prefill."""
    cs = _chip_smoke()
    lm = cs.phase_lm_plane("cpu", make="make_smoke", n_requests=3,
                           max_prompt=40, max_seq=64, max_new=4, slots=2,
                           users=3, total_steps=160, image_dim=16)
    assert lm["flash_attention_launches"] == lm["ssd_scan_launches"] == 0
    gw = lm["gateway"]
    assert gw["expected_launches"] == {
        "flash_attention": 2 * gw["lm_requests"]["qwen2-0.5b"],
        "ssd_scan": 2 * gw["lm_requests"]["mamba2-130m"]}
    for name, run in lm["engine_runs"].items():
        assert run["prefills"] == 3
        kname = cs.LM_KERNEL[name]
        assert run["expected_launches"][kname] == 2 * 3
        kv = run["kernel_vs_plain_prefill"]
        assert kv["rel_err"] <= cs.LM_PREFILL_TOL and kv["same_argmax"]
        assert sum(lm["bucket_counts"][name].values()) == \
            3 + gw["lm_requests"][name]
    assert cs.modal_bucket({"8": 3, "64": 3, "16": 1}) == 64


@pytest.fixture
def one_thread():
    """One intra-op thread: under the suite's six workers, torch's thread
    pools on every worker contend for the cores, and these checks' many
    small ops then ran ~30x slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_chip_smoke_kernel_checks_run_on_cpu(monkeypatch, one_thread):
    """Phase 3's flash/ssd cases run (plain against plain) on the CPU; the
    flash case at L = 4096 (a 4096 x 4096 score matrix per head) is left
    to the card."""
    cs = _chip_smoke()
    small = [c for c in cs.FLASH_CHECK_CASES if c[3] <= 512]
    assert len(small) == len(cs.FLASH_CHECK_CASES) - 1
    monkeypatch.setattr(cs, "FLASH_CHECK_CASES", small)
    fl = cs._check_flash("cpu")
    assert len(fl["cases"]) == len(small)
    assert fl["rel_err"] == 0.0
    assert fl["constant_v_max_abs_err"] <= 1e-5
    ssd = cs._check_ssd("cpu")
    assert len(ssd["cases"]) == len(cs.SSD_CHECK_CASES)
    assert all(c["kernel_vs_exact"] == c["plain_vs_exact"]
               for c in ssd["cases"])
    assert ssd["kernel_vs_exact"] <= 1.0


def test_flash_check_catches_what_the_allclose_lets_pass(monkeypatch):
    """Outputs 1.5% too large pass rtol = atol = 2e-2 everywhere, but not
    the check of the error against the outputs' norm."""
    cs = _chip_smoke()
    from repro_torch.kernels import ref
    case = (1, 14, 2, 128, 128, 64, None, torch.bfloat16, True)
    monkeypatch.setattr(cs, "FLASH_CHECK_CASES", [case])
    monkeypatch.setattr(
        cs.ops, "flash_attention",
        lambda q, k, v, **kw: ref.flash_attention_ref(q, k, v, **kw) * 1.015)
    q, k, v = cs._flash_inputs(*case[:6], case[7], "cpu", 200)
    out = cs.ops.flash_attention(q, k, v, causal=True)
    assert torch.allclose(out.float(), ref.flash_attention_ref(
        q, k, v, causal=True).float(), rtol=2e-2, atol=2e-2)
    with pytest.raises(cs.SmokeError, match="relative error"):
        cs._check_flash("cpu")


def _ssd_exact_einsum(x, dt, A, Bm, Cm, D):
    """chip_smoke's f64 recurrence as it was first written, one einsum
    pair per step: the reference for its faster in-place form."""
    x, dt, A, Bm, Cm, D = (t.double() for t in (x, dt, A, Bm, Cm, D))
    B, L, H, P = x.shape
    rep = H // Bm.shape[2]
    Bh, Ch = (t.repeat_interleave(rep, dim=2) for t in (Bm, Cm))
    S = x.new_zeros((B, H, P, Bm.shape[3]))
    ys = []
    for t in range(L):
        S = S * torch.exp(dt[:, t] * A)[:, :, None, None] + torch.einsum(
            "bh,bhp,bhn->bhpn", dt[:, t], x[:, t], Bh[:, t])
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], S))
    return torch.stack(ys, dim=1) + x * D[None, None, :, None], S


@pytest.mark.parametrize("shape", [(2, 40, 4, 8, 2, 16), (1, 64, 6, 16, 3, 8)])
def test_ssd_exact_matches_the_einsum_recurrence(shape):
    """The in-place f64 recurrence gives the einsum form's answer (two
    groups, batch 2) to f64 rounding."""
    cs = _chip_smoke()
    args = cs._ssd_inputs(*shape, "cpu", 11)
    for got, want in zip(cs.ssd_exact(*args), _ssd_exact_einsum(*args)):
        assert got.dtype == torch.float64 and got.shape == want.shape
        assert (got - want).abs().max().item() <= 1e-12 * \
            want.abs().max().item()


def test_ssd_exact_matches_the_chunked_plain_version():
    """chip_smoke's f64 step-by-step SSD agrees with the chunked plain
    version well inside the tolerance at a small, ragged shape."""
    cs = _chip_smoke()
    args = cs._ssd_inputs(2, 40, 4, 8, 2, 16, "cpu", 5)
    y64, s64 = cs.ssd_exact(*args)
    y, s = ref_ssd(*args)
    assert cs._tol_ratio(y, y64, cs.SSD_TOL) < 0.1
    assert cs._tol_ratio(s, s64, cs.SSD_TOL) < 0.1


def test_chip_smoke_chain_checks_run_on_cpu(monkeypatch):
    """Phase 3's ddpm_chain cases run (plain against plain) on the CPU,
    each within its tolerance of the exact f64 chain; the 1000-step case
    (thousands of small ops twice over) is left to the card."""
    cs = _chip_smoke()
    short = [c for c in cs.CHAIN_CASES if c[4] <= 50]
    assert len(short) == len(cs.CHAIN_CASES) - 1
    monkeypatch.setattr(cs, "CHAIN_CASES", short)
    out = cs._check_chain("cpu")
    assert [c["case"] for c in out["cases"]] == [c[0] for c in short]
    assert out["max_abs_err"] == 0.0
    assert all(c["kernel_vs_exact"] == c["plain_vs_exact"] <= 1.0
               for c in out["cases"])
    # 2e-5 per 50 steps
    assert cs.chain_exact_tol(5) == 2e-5 and cs.chain_exact_tol(1000) == 4e-4
    # two row blocks and widths the cluster of 8 does not divide
    odd = out["cases"][4]
    assert odd["case"] == "odd_widths" and odd["R"] == 9
    assert odd["plan"]["rows"] == 8 and odd["plan"]["cluster"] == 8


def test_chip_smoke_chain_grad_checks_run_on_cpu(one_thread):
    """Phase 3's ddpm_chain_bwd cases on the CPU: the plain backward
    against itself on the plain forward's record (0 apart, the same bits
    twice), each within ``chain_grad_exact_tol`` of the exact f64
    gradients; no launch on the CPU."""
    cs = _chip_smoke()
    out = cs._check_chain_grad("cpu")
    assert [c["case"] for c in out["cases"]] == \
        [c[0] for c in cs.CHAIN_GRAD_CASES]
    assert out["max_abs_err"] == out["rel_err"] == 0.0
    for c in out["cases"]:
        assert c["same_bits"] and c["record_max_abs_err"] == 0.0
        assert c["exact_rel_err"] == c["plain_exact_rel_err"] <= c["exact_tol"]
        assert c["launches"] == {"ddpm_chain": 0, "ddpm_chain_bwd": 0}
    by = {c["case"]: c for c in out["cases"]}
    # one R over five clusters, a ragged R over two, and a 50-step chain
    assert by["R37"]["plan"]["rows"] == 8 and -(-37 // 8) == 5
    assert by["odd_widths"]["R"] == 9 and by["L50"]["L"] == 50
    assert cs.chain_grad_exact_tol(5) == 2e-5
    assert cs.chain_grad_exact_tol(100) == 4e-5


def test_chain_grad_check_catches_a_gradient_off_by_1e4(monkeypatch):
    """A gradient 1e-4 too large (relative) fails against the plain
    backward."""
    cs = _chip_smoke()
    grad = cs._chain_grad
    monkeypatch.setattr(cs, "_chain_grad", lambda c, w: tuple(
        g * (1 + 1e-4) for g in grad(c, w)))
    monkeypatch.setattr(cs, "CHAIN_GRAD_CASES", cs.CHAIN_GRAD_CASES[:1])
    with pytest.raises(cs.SmokeError, match="ddpm_chain_bwd"):
        cs._check_chain_grad("cpu")


def test_chain_bwd_bound_counts_the_kernels_work():
    cs = _chip_smoke()
    ms, by = cs.chain_bwd_bound_ms(cs.CTRL_DIMS, 50, 64, 5)
    pairs = [(86, 128), (128, 128), (128, 128), (128, 20)]
    step = 20 + sum(2 * i * o + o for i, o in pairs) \
        + 2 * (128 * 128 * 2 + 128 * 20)
    flops = 64 * (5 * step + 4 * (2 * 20 * 128 + 2 * 20))
    assert by == "operations"
    assert ms == pytest.approx(1e3 * flops / 67e12)
    ms, by = cs.chain_bwd_bound_ms(cs.CTRL_DIMS, 50, 1, 1)
    weights = 86 * 128 + 2 * 128 * 128 + 128 * 20
    nbytes = 4 * (weights + 404 + 50 + 20 + 19 + weights + 3 * 128 + 20)
    assert by == "bytes" and ms == pytest.approx(1e3 * nbytes / 3.35e12)


def test_chain_check_catches_a_chain_off_by_1e4(monkeypatch):
    """x_0 1e-4 too large (relative) passes no case: the allclose at 2e-5
    catches it where L <= 50, the f64 chain where L > 50 (a small net at
    L = 60 here)."""
    cs = _chip_smoke()
    from repro_torch.kernels import ref
    monkeypatch.setattr(cs.ops, "ddpm_chain",
                        lambda *a: ref.ddpm_chain_ref(*a) * (1 + 1e-4))
    for case in (cs.CHAIN_CASES[0],
                 ("long", (24, 16, 16, 4), 4, 1, 60, "linear")):
        monkeypatch.setattr(cs, "CHAIN_CASES", [case])
        with pytest.raises(cs.SmokeError, match="ddpm_chain"):
            cs._check_chain("cpu")


def test_chain_bound_counts_the_kernels_work():
    cs = _chip_smoke()
    ms, by = cs.chain_bound_ms(cs.DATA_DIMS, 1, 1, 1000)
    # per step: 272x128, 2 x 128x128, 128x256 products, biases, update
    step = 2 * (272 * 128 + 2 * 128 * 128 + 128 * 256) + 3 * 128 + 256 \
        + 5 * 256
    assert by == "operations"
    assert ms == pytest.approx(1e3 * (2 * 1 * 128 + 1000 * step) / 67e12)
    ms, by = cs.chain_bound_ms(cs.CTRL_DIMS, 50, 1, 5)
    weights = 86 * 128 + 2 * 128 * 128 + 128 * 20 + 3 * 128 + 20
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * 4 * (weights + 40 + 50 + 100 + 5 * 19)
                               / 3.35e12)


def test_lm_kernel_bounds():
    cs = _chip_smoke()
    ms, by, peak = cs.flash_bound_ms(1, 512, 512, 14, 2, 64, 2)
    pairs = 512 * 513 // 2
    assert by == "bytes" and "bf16" in peak
    assert ms == pytest.approx(1e3 * 2 * (2 * 512 * 14 * 64 + 2 * 512 * 2 * 64)
                               / 3.35e12)
    assert cs.flash_bound_ms(1, 4096, 4096, 14, 2, 64, 2)[1] == "operations"
    # a window keeps fewer pairs; f32 runs against the CUDA-core peak
    w, _, p32 = cs.flash_bound_ms(1, 4096, 4096, 8, 8, 128, 4, window=64)
    assert "f32" in p32 and w > 0
    assert cs.flash_bound_ms(1, 8, 8, 1, 1, 64, 4, causal=False)[0] > 0
    ms, by, _ = cs.ssd_bound_ms(1, 512, 24, 64, 1, 128, 128)
    per_chunk = 8256 * (2 * 128 + 2 * 64) + 4 * 128 * 128 * 64 + 2 * 128 * 64
    assert by == "operations"
    assert ms == pytest.approx(1e3 * 24 * 4 * per_chunk / 67e12)
    assert pairs == 131328


def ref_ssd(*args):
    from repro_torch.kernels import ref
    return ref.ssd_scan_ref(*args, chunk=16)


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


def test_kernels_line_sums_the_path_over_buckets():
    """``path_ms`` and ``path_bound_ms`` are launches times ms or bound
    over the buckets the path ran; the modal and long shapes are quoted."""
    cs = _chip_smoke()
    rows = [(L, {"shape": [1, L], "ms": 0.01 * L, "graph_ms": 0.001 * L,
                 "plain_ms": 1.0, "bound_ms": 1e-4 * L, "bound_by": "bytes",
                 "library_ms": None, "grids_per_call": 1 + 2 * (L > 128)})
            for L in (8, 64, 512, 4096)]
    out = cs.kernel_summary(rows, {8: 48, 512: 24}, 8, (512, 4096),
                            path_grids=48 + 3 * 24)
    assert out["grids_per_call"] == pytest.approx(120 / 72)
    assert out["ms"] == pytest.approx(0.08) and out["shape"] == [1, 8]
    assert out["path_ms"] == pytest.approx(48 * 0.08 + 24 * 5.12)
    assert out["path_graph_ms"] == pytest.approx(48 * 0.008 + 24 * 0.512)
    assert out["path_bound_ms"] == pytest.approx(48 * 8e-4 + 24 * 0.0512)
    assert [p["launches"] for p in out["path"]] == [48, 24]
    assert out["at"]["4096"]["grids_per_call"] == 3
    assert out["at"]["512"]["ms"] == pytest.approx(5.12)


def test_kernels_line_grids_come_from_the_path_run():
    """``grids_per_call`` is the serving path's grids over its launches; a
    count that the shapes' timed calls do not account for fails."""
    cs = _chip_smoke()
    rows = [(L, {"shape": [1, L], "ms": 1.0, "graph_ms": 1.0,
                 "plain_ms": 1.0, "bound_ms": 1.0, "bound_by": "bytes",
                 "library_ms": None, "grids_per_call": 1 + 2 * (L > 128)})
            for L in (8, 512)]
    with pytest.raises(cs.SmokeError, match="grids"):
        cs.kernel_summary(rows, {8: 24, 512: 24}, 8, (), path_grids=48)
    assert cs.kernel_summary(rows, {8: 24, 512: 24}, 8, (),
                             path_grids=24 + 3 * 24)["grids_per_call"] == 2


def test_chip_smoke_vector_phase_runs_small_on_cpu(one_thread):
    """The vector-env phase at a small env on the CPU: the fused run's
    gate count, history shape and learners moved, the shared learner over
    masked cells, a 2-member population and its ranking, the SCHRS episode
    and lockstep slot; no launch on the CPU, the launches the card must
    make computed all the same (one chain a slot whatever B, 2 + 1 a
    stacked update)."""
    cs = _chip_smoke()
    from repro_torch.core.env import EnvCfg
    out = cs.phase_vector("cpu", EnvCfg(U=3, M=4, T=10, K=4), episodes=3,
                          B=3, shared_counts=(3, 2),
                          members=cs.POP_MEMBERS[:2],
                          ga=cs.GACfg(pop=6, gens=2))
    fused = out["fused"]
    assert fused["history_shape"] == [3, 3] and fused["d3pg_updates"] == 20
    assert fused["expected_launches"] == {"ddpm_chain": 3 * 40 + 2 * 20,
                                          "ddpm_chain_bwd": 20,
                                          "ddpm_step": 0, "ddpm_step_bwd": 0}
    assert sum(fused["launches"].values()) == 0               # CPU
    assert fused["launches_by_shape"]["ddpm_chain"] == {
        "B3_R1": 120, "B3_R64": 20, "B3_R64+record": 20}
    assert len(fused["wall_s_per_episode"]) == 3
    upd = out["fused_update"]
    assert upd["B"] == 3 and len(upd["losses"]["actor_loss"]) == 3
    assert upd["fused"]["ms"] > 0 and upd["single_x_B"]["ms"] > 0
    assert out["shared"]["launches_by_shape"]["ddpm_chain_bwd"] == {
        "train": out["shared"]["d3pg_updates"]}
    pop = out["population"]
    assert len(pop["ranking"]) == 2 and pop["groups"][0]["members"] == [
        m.label() for m in cs.POP_MEMBERS[:2]]
    assert out["schrs"]["ms_per_slot"] > 0
    by, grids = cs._vector_paths(out, "ddpm_chain")
    assert by["B3_R1"] == 120 and by["B2_R1"] == 4 * 40 and grids == 0


def test_chip_smoke_stacked_checks_run_on_cpu(one_thread):
    """Phase 3's learner-axis cases on the CPU (plain stacked against the
    plain single-learner versions, slice by slice), at every (B, R) the
    vector-env phase launches (the fused run's 8 learners and the
    population's 4) and that the timing phase times."""
    cs = _chip_smoke()
    out = cs._check_chain_stacked("cpu")
    assert [c["case"] for c in out["cases"]] == [
        c[0] for c in cs.STACKED_CASES]
    paths = {(cs.VECTOR_B, 1), (cs.VECTOR_B, 64),
             (len(cs.POP_MEMBERS), 1), (len(cs.POP_MEMBERS), 64)}
    assert paths == set(cs.STACKED_TIMING)
    assert paths <= {(c["B"], c["R"]) for c in out["cases"]}
    assert all(c["learner_slices_bit_equal"] for c in out["cases"])
    assert out["max_abs_err"] == 0.0 and out["bwd_rel_err"] == 0.0


def test_chip_smoke_ops_phase_runs_small_on_cpu(one_thread):
    """The ops phase (classical cachers, scenarios, checkpoints,
    telemetry) end to end on the CPU at a tiny size: every check in it
    holds, its runs' launches are counted by the shapes the kernels line
    reads, and it names its card (none here)."""
    from repro_torch.core.env import EnvCfg
    cs = _chip_smoke()
    out = cs.phase_ops("cpu", EnvCfg(U=3, M=4, T=4, K=3), B=2, scenario_B=2,
                       warmup=3)
    assert out["phase"] == "ops" and out["card"] is None
    assert set(out["cachers"]) == {"lru", "lfu", "lru-ghost", "arc",
                                   "arc_fused_B2"}
    assert set(out["replay"]) == {f"{k}/B{b}" for k in
                                  ("lru", "lfu", "lru-ghost", "arc")
                                  for b in (1, 2)}
    assert set(out["scenarios"]) >= {"paper-default", "diurnal",
                                     "flash-crowd", "hetero-cells",
                                     "degraded-channel"}
    assert out["scenarios"]["hetero-cells"]["cells"] == 2
    assert out["checkpoint"]["bytes"] > 0
    assert out["telemetry"]["record_kinds"] == ["manifest", "train_chunk",
                                                "eval"]
    by = out["launches_by_shape"]
    assert by["ddpm_chain"]["control"] > 0 and by["ddpm_chain"]["B2_R1"] > 0
    assert by["ddpm_chain"]["control_R64+record"] \
        > by["ddpm_chain"]["control_R64"] > 0
    assert by["ddpm_chain_bwd"]["train"] == by["ddpm_chain"]["control_R64"] \
        + out["telemetry"]["diag_updates"]


def test_chip_smoke_dist_phase_runs_small_on_cpu(one_thread):
    """Phase dist on the CPU: the world of one and the world of two on
    gloo (two spawned worlds), 4 cells at a tiny EnvCfg, deepseek-v2's
    MoE layer and deepseek-v3's forward at their smoke widths, the LM's
    mesh half on a (1, 1) mesh at smoke widths (qwen2 and mamba2 serving,
    two FSDP train steps), and the example twins at tiny arguments.  The ranks unpickle their function
    from the module ``chip_smoke``, so it is registered under that name
    and the repository root is importable (the card runs the script as
    ``__main__``, which the spawn start method imports alike)."""
    cs = _chip_smoke()
    sys.modules["chip_smoke"] = cs
    sys.path.insert(0, str(REPO))
    try:
        out = cs.phase_dist(
            "cpu", cs.EnvCfg(U=3, M=4, T=10, K=6), B=4, episodes=2,
            moe=("deepseek-v2-236b", "make_smoke"), moe_tokens=(2, 8),
            lm=("deepseek-v3-671b", "make_smoke"), lm_tokens=(2, 8),
            examples={"quickstart_torch": ["--episodes", "1"],
                      "serve_edge_torch": ["--train-episodes", "1",
                                           "--frames", "1", "--slots", "2"],
                      "train_lm_torch": ["--steps", "1", "--batch", "1",
                                         "--seq-len", "8"]},
            timeout_s=240, make="make_smoke", prompts=(2, 16), decode=2,
            fsdp=dict(arch="qwen2-0.5b", steps=2, batch=2, seq_len=16,
                      lr=3e-4))
    finally:
        sys.path.remove(str(REPO))
        del sys.modules["chip_smoke"]
    assert out["phase"] == "dist" and out["d3pg_updates"] > 0
    assert set(out["worlds"]) == {"1", "2"}
    w1, w2 = out["worlds"]["1"], out["worlds"]["2"]
    assert w1["backend"] == w2["backend"] == "gloo"
    assert [t["cells"] for t in w2["train"]] == [[0, 2], [2, 4]]
    assert all(t["updates"] == out["d3pg_updates"]
               for w in (w1, w2) for t in w["train"])
    assert w2["train"][0]["gather_bytes"] > 0
    for m in w2["moe"]:
        assert m["experts_per_rank"] * 2 == m["experts"]
        assert m["y_max_abs_err"] <= 2e-2
    assert all(x["logits_max_abs_err"] <= 2e-5 for x in w2["lm"])
    # the LM's mesh half in the world of one, on a (1, 1) mesh
    for r in w1["serve"][0]:
        assert r["mesh"] == [1, 1] and r["max_rel_err"] <= 5e-2
        assert r["weight_bytes_per_rank"] == r["weight_bytes_unsharded"]
    f = w1["fsdp"][0]
    assert f["update_max_rel_l2"] == f["leaf_max_abs_diff"] == 0.0
    assert len(f["losses"]) == 2 and f["loss_max_rel_err"] == 0.0
    assert out["per_rank_bytes"]
    assert set(out["examples"]) == {"quickstart_torch", "serve_edge_torch",
                                    "train_lm_torch"}
    shapes = out["launches_by_shape"]["ddpm_chain"]
    assert shapes["B4_R64"] == out["d3pg_updates"]
    assert shapes["B2_R1"] == 2 * 10 * 6 * 2
