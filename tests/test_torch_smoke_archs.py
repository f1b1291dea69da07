"""chip_smoke.py's fleet and lm_archs phases, small on the CPU: what they
check and count rehearsed without the card (no kernel launches here; the
launches the card must make are computed all the same), and the shapes
and cuts they run at full width."""
import importlib.util
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_fleet_phase_runs_small_on_cpu():
    cs = _chip_smoke()
    from repro_torch.core.env import EnvCfg
    from repro_torch.fleet import FleetCfg
    fl = cs.phase_fleet("cpu", EnvCfg(U=4, M=4, T=2, K=3),
                        FleetCfg(ticks_per_slot=5, arrivals_per_user_s=0.3),
                        cells=3, warmup=3)
    assert set(fl["runs"]) == {"t2drl", "t2drl_C1", "rcars"}
    for run in fl["runs"].values():
        assert run["requests"] == run["admitted"] + run["dropped"] > 0
        assert sum(run["launches"].values()) == 0          # CPU
    # one chain a slot on the card, at R = cells and at R = 1
    assert fl["launches_by_shape"] == {"ddpm_chain": {"control_R3": 6,
                                                      "control": 6}}
    assert fl["cell0"]["arrivals"] == fl["cell0"]["arrivals_alone"]
    assert fl["cell0"]["lat_sum_rel_diff"] <= cs.FLEET_CELL0_LAT_TOL


def test_lm_archs_phase_runs_small_on_cpu():
    cs = _chip_smoke()
    ar = cs.phase_lm_archs("cpu", make="make_smoke", n_requests=2,
                           max_prompt=24, max_seq=64, max_new=3)
    assert list(ar["archs"]) == list(cs.ARCH_ORDER)
    for name, row in ar["archs"].items():
        assert row["kernel_vs_plain_prefill"]["rel_err"] == 0.0, name
        assert row["weights_bytes"] > 0 and row["reduced"] == []
        assert sum(row["launches"].values()) == 0              # CPU
    assert ar["archs"]["internvl2-2b"]["prefix_prefill"]["text_tokens"] \
        == 64 - 8
    # launches the card must make: one flash a prefill for each attention
    # layer, one ssd_scan for each Mamba2 layer
    zamba = ar["archs"]["zamba2-7b"]
    assert (zamba["attention_layers"], zamba["ssm_layers"]) == (1, 3)
    assert ar["flash_attention_launches"] == sum(
        ar["launches_by_shape"]["flash_attention"].values()) > 0
    assert ar["ssd_scan_launches"] == 2 * (2 + 3)   # mamba2, zamba2 x 2
    # the smoke widths' MLA prefills run the plain products, counted
    assert ar["flash_mla_launches"] == 0
    assert ar["plain_mla_prefills"] == sum(
        r.get("plain_mla_prefills", 0) for r in ar["archs"].values()) > 0


def test_full_width_cuts_and_launch_shapes():
    """What the card runs: every architecture at full width but
    deepseek-v2 (depth 2) and deepseek-v3 (smoke width); zamba2-7b's
    prefill launches flash at d_head 112 13 times and ssd_scan 68 times."""
    cs = _chip_smoke()
    for name in cs.ARCH_ORDER:
        cfg, cut = cs._arch_cfg(name, "make_full")
        assert bool(cut) == name.startswith("deepseek"), name
    cfg, _ = cs._arch_cfg("deepseek-v2-236b", "make_full")
    assert cfg.n_layers == 2 and cfg.d_model == 5120
    assert cfg.groups[1].cycle[0].moe.n_experts == 160
    zamba, _ = cs._arch_cfg("zamba2-7b", "make_full")
    shapes = cs._prefill_shapes(zamba, 300)
    assert shapes["flash_attention"] == {"1x300x32x32x112": 13}
    assert shapes["ssd_scan"] == {"1x300x112x64x2x64x128": 68}
    whisper, _ = cs._arch_cfg("whisper-small", "make_full")
    assert cs._prefill_shapes(whisper, 16)["flash_attention"] == {
        "1x16x12x12x64": 12}
    qwen3, _ = cs._arch_cfg("qwen3-4b", "make_full")
    assert cs._prefill_shapes(qwen3, 8)["flash_attention"] == {
        "1x8x32x8x128": 36}


def test_mla_prefill_launch_shapes_and_plain_counts():
    """deepseek-v2 at full width launches flash_mla at (192, 128) once a
    layer a prefill and runs no plain MLA prefill; the smoke widths run
    the plain products in every MLA layer; flash_mla's bound counts v's
    head size of its own (as ``perfbench/counts/moe_lm.py`` does)."""
    cs = _chip_smoke()
    v2, _ = cs._arch_cfg("deepseek-v2-236b", "make_full")
    assert cs._prefill_shapes(v2, 512)["flash_mla"] == {
        "1x512x128x128x192x128": 2}
    assert cs._plain_mla_layers(v2) == 0
    v3, _ = cs._arch_cfg("deepseek-v3-671b", "make_full")
    assert cs._prefill_shapes(v3, 64)["flash_mla"] == {}
    assert cs._plain_mla_layers(v3) == len(cs._mixer_blocks(v3, "mla")) > 0
    from perfbench.counts import moe_lm
    for L in cs.MLA_TIMING_L:
        ms, by, _ = cs.flash_bound_ms(1, L, L, *cs.MLA_HEADS[:3], 2,
                                      DV=cs.MLA_HEADS[3])
        assert ms == pytest.approx(1e3 * moe_lm.flash_bound_s(
            1, L, L, *cs.MLA_HEADS))
    assert cs.flash_bound_ms(1, 512, 512, 32, 8, 128, 2, DV=128) \
        == cs.flash_bound_ms(1, 512, 512, 32, 8, 128, 2)


def test_flash_mla_summary_sums_its_path_and_quotes_deepseek_heads():
    """flash_mla's ``kernels`` entry: the path is phase lm_archs' launches
    by shape, the long shapes DeepSeek's heads at 512 and 4096, and the
    plain MLA prefills beside it."""
    cs = _chip_smoke()
    rows = [{"shape": [1, L, 128, 128, 192, 128], "ms": 1e-3 * L,
             "graph_ms": 1e-3 * L, "plain_ms": 1.0, "bound_ms": 1e-4 * L,
             "bound_by": "bytes", "library_ms": 5e-4 * L,
             "grids_per_call": 1.0, "max_abs_err": 0.015625}
            for L in (128, 256) + cs.MLA_TIMING_L]
    archs = {"launches_by_shape": {"flash_mla": {
        "1x128x128x128x192x128": 2, "1x256x128x128x192x128": 4}},
        "grids": {"flash_mla": 6}, "plain_mla_prefills": 8}
    out = cs.flash_mla_summary(archs, rows)
    assert out["shape"] == [1, 256, 128, 128, 192, 128]
    assert out["path_ms"] == pytest.approx(2 * 0.128 + 4 * 0.256)
    assert out["launches_by_phase"] == {"lm_archs": 6}
    assert out["plain_mla_prefills"] == 8
    assert set(out["at"]) == {"1x512x128x128x192x128",
                              "1x4096x128x128x192x128"}
