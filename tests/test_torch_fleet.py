"""The fleet serving twin of the port (``repro_torch.fleet``) against the
JAX package's (``repro.fleet``), on the CPU.

* ``latency_quantiles``, ``_frame_series`` and ``summarize_fleet`` equal
  the reference's on the same numpy inputs (exactly);
* one slot's tick recursion and batched pass equal a numpy transcription
  of the reference's tick body (``repro/fleet/twin.py:180-220``) given the
  same Poisson draws, at 1e-6 relative (the port sums a slot's latencies
  in another order);
* ``simulate_fleet`` on a JAX state crossed over through the bridge holds
  in distribution: arrivals, admissions and the p50/p95 latencies over 8
  seeds of the port have their median inside the reference's range over
  8 seeds (the draws differ by design);
* the behavioural tests of tests/test_fleet.py, mirrored: conservation,
  the seed pin, the cloud path, population scaling, scenario traffic,
  counted truncation, batched states fixing the fleet size, and a
  JAX-written checkpoint that loads and serves.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_train_state as jsave
from repro.core import EnvCfg as JEnvCfg
from repro.core import T2DRLCfg as JCfg
from repro.core import t2drl_init as jinit
from repro.fleet import FleetCfg as JFleetCfg
from repro.fleet import simulate_fleet as jsimulate
from repro.fleet import twin as jtwin
from repro_torch.bridge import train_state_from_numpy
from repro_torch.checkpoint import load_train_state
from repro_torch.core import EnvCfg, T2DRLCfg, t2drl_init
from repro_torch.core.t2drl import t2drl_init_batch, train_t2drl
from repro_torch.device import make_generator
from repro_torch.fleet import (FleetCfg, latency_quantiles, simulate_fleet,
                               summarize_fleet)
from repro_torch.fleet import twin
from repro_torch.scenarios import build_scenario

SMALL = dict(U=4, M=4, T=3, K=3)
ENV = EnvCfg(**SMALL)
CFG = T2DRLCfg(env=ENV, warmup=5, lr_actor=1e-4, lr_critic=1e-4,
               lr_ddqn=1e-3, L=2, eps_decay_episodes=4, seed=0)
RCARS = T2DRLCfg(env=ENV, allocator="rcars", cacher="random", L=2, seed=0)
FCFG = FleetCfg(ticks_per_slot=5, arrivals_per_user_s=0.5)
CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ts_rcars():
    return t2drl_init(make_generator(0, "cpu"), RCARS)


@pytest.fixture(scope="module")
def ts_t2drl():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ts, _ = train_t2drl(CFG, episodes=2, device="cpu")
    finally:
        torch.set_num_threads(n)
    return ts


def _jcfg(cfg: T2DRLCfg):
    """The JAX twin of one of this file's configs."""
    keep = ("allocator", "cacher", "policy", "warmup", "lr_actor",
            "lr_critic", "lr_ddqn", "L", "eps_decay_episodes", "seed")
    return JCfg(env=JEnvCfg(**dataclasses.asdict(cfg.env)),
                **{k: getattr(cfg, k) for k in keep})


def _fleet_inputs(seed, C=2, T=3):
    """Per-cell counts, histograms, curves and snapshots of a fleet run,
    made up from ``seed`` with numpy."""
    rng = np.random.default_rng(seed)
    K, bins = 3, 16
    snap_hist = np.cumsum(rng.integers(0, 5, (C, T, bins)), axis=1)
    snap_counts = {k: np.cumsum(rng.integers(0, 9, (C, T)), axis=1)
                   for k in twin.COUNT_KEYS}
    snap_counts["lat_sum"] = np.cumsum(rng.random((C, T)) * 50, axis=1)
    snap_counts["wait_sum"] = np.cumsum(rng.random((C, T)) * 20, axis=1)
    counts = {k: v[:, -1] for k, v in snap_counts.items()}
    counts["end_backlog"] = rng.random(C) * 3
    curves = {"backlog": rng.random((C, T, K)) * 4,
              "depth": rng.random((C, T, K)) * 9}
    return counts, snap_hist[:, -1], curves, {"counts": snap_counts,
                                              "hist": snap_hist}


@pytest.mark.parametrize("seed", [0, 1])
def test_host_functions_equal_the_reference(seed):
    counts, hist, curves, snaps = _fleet_inputs(seed)
    fc = FleetCfg(hist_bins=16, hist_max=30.0)
    jfc = JFleetCfg(hist_bins=16, hist_max=30.0)
    for qs in ((0.5, 0.95, 0.99), (0.1, 0.25, 1.0)):
        for h in (hist.sum(0), np.zeros(16), np.eye(16)[15] * 3):
            a = latency_quantiles(h, 30.0, qs)
            b = jtwin.latency_quantiles(h, 30.0, qs)
            assert a.keys() == b.keys()
            np.testing.assert_array_equal(list(a.values()), list(b.values()))
    assert twin._frame_series(snaps, curves, fc) == \
        jtwin._frame_series(snaps, curves, jfc)
    got = summarize_fleet(counts, hist, curves, CFG, fc, 1.5, snaps=snaps)
    want = jtwin.summarize_fleet(counts, hist, curves, _jcfg(CFG), jfc, 1.5,
                                 snaps=snaps)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k], dtype=object),
                                      np.asarray(want[k], dtype=object),
                                      err_msg=k)


def _numpy_slot(work, serv, trans, cached, n_raw, fc, tau, dt):
    """The reference's tick body (repro/fleet/twin.py:180-220) for one cell
    and one slot in float32 numpy, on given Poisson draws (ticks, M)."""
    f32 = np.float32
    A = fc.max_arrivals
    k = np.arange(1, A + 1, dtype=f32)
    hist = np.zeros(fc.hist_bins, np.int64)
    c = dict.fromkeys(twin.COUNT_KEYS, 0)
    c.update(lat_sum=0.0, wait_sum=0.0)
    for nr in n_raw.astype(f32):
        n = np.minimum(nr, f32(A))
        depth = work / np.maximum(serv, f32(1e-6))
        room = np.floor(np.maximum(f32(fc.queue_cap) - depth, f32(0)))
        adm = np.where(cached > 0, np.minimum(n, room), n)
        valid = k[None, :] <= adm[:, None]
        wait = np.where(cached[:, None] > 0,
                        work[:, None] + (k[None, :] - f32(1)) * serv[:, None],
                        f32(0))
        lat = trans[:, None] + wait + serv[:, None]
        idx = np.clip((lat / f32(fc.hist_max) * f32(fc.hist_bins))
                      .astype(np.int32), 0, fc.hist_bins - 1)
        np.add.at(hist, idx.ravel(), valid.ravel().astype(np.int64))
        c["arrivals"] += int(n.sum())
        c["admitted"] += int(adm.sum())
        c["dropped"] += int(np.where(cached > 0, n - adm, 0).sum())
        c["truncated"] += int((nr - n).sum())
        c["slo_viol"] += int((valid & (lat > f32(fc.slo))).sum())
        c["deadline_miss"] += int((adm * (trans + serv > f32(tau))).sum())
        c["lat_sum"] += float((valid * lat).sum(dtype=np.float64))
        c["wait_sum"] += float((valid * wait).sum(dtype=np.float64))
        work = np.maximum(work + np.where(cached > 0, adm * serv, f32(0))
                          - f32(dt), f32(0)).astype(f32)
    return c, hist, work


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tick_pass_equals_the_reference_tick_body(seed):
    """Queues near their cap (drops), serv below the 1e-6 floor, cached and
    uncached models, truncated arrivals: one slot of the port's recursion
    and batched pass against the reference's tick body per cell."""
    rng = np.random.default_rng(seed)
    C, M, Tk = 3, 5, 7
    fc = FleetCfg(ticks_per_slot=Tk, max_arrivals=4, queue_cap=6.0,
                  slo=12.0, hist_bins=32, hist_max=40.0)
    tau, dt = 20.0, 20.0 / Tk
    f32 = np.float32
    work = (rng.random((C, M)) * 15).astype(f32)
    serv = (rng.random((C, M)) * 4 + 0.2).astype(f32)
    serv[0, 0] = 1e-8
    trans = (rng.random((C, M)) * 18).astype(f32)
    cached = (rng.random((C, M)) < 0.7).astype(f32)
    n_raw = rng.poisson(rng.random((C, M)) * 5, (Tk, C, M)).astype(f32)
    assert (n_raw > fc.max_arrivals).any()
    t = lambda a: torch.tensor(a)  # noqa: E731
    counts = {k: torch.zeros(C, dtype=torch.int32) for k in twin.COUNT_KEYS}
    counts.update(lat_sum=torch.zeros(C), wait_sum=torch.zeros(C))
    hist = torch.zeros((C, fc.hist_bins), dtype=torch.int32)
    n = torch.clamp_max(t(n_raw), float(fc.max_arrivals))
    W, adm, end = twin._tick_recursion(t(work), n, t(serv), t(cached) > 0,
                                       fc, dt)
    twin._slot_pass(counts, hist, W, adm, t(n_raw), n, t(serv), t(trans),
                    t(cached) > 0, fc, tau)
    dropped = 0
    for c in range(C):
        want, whist, wwork = _numpy_slot(work[c], serv[c], trans[c],
                                         cached[c], n_raw[:, c], fc, tau, dt)
        np.testing.assert_array_equal(hist[c].numpy(), whist)
        np.testing.assert_allclose(end[c].numpy(), wwork, rtol=1e-6)
        for k in twin.COUNT_KEYS:
            assert int(counts[k][c]) == want[k], k
        for k in ("lat_sum", "wait_sum"):
            np.testing.assert_allclose(float(counts[k][c]), want[k],
                                       rtol=1e-6, err_msg=k)
        dropped += want["dropped"]
    assert dropped > 0 and counts["truncated"].sum() > 0
    assert counts["arrivals"].dtype == torch.int32 == hist.dtype


# -- whole horizons against the reference, in distribution -------------------

def _scaled_jax_state():
    """A fresh JAX d3pg/ddqn state with the actor's output layer scaled by
    0.05 (x_0 stays O(1), away from where XLA's and torch's tanh saturate
    apart; ROADMAP queue C), as numpy."""
    jcfg = _jcfg(CFG)
    ts = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(4), jcfg))
    last = ts["d3pg"]["actor"]["layers"][-1]
    last["w"] = last["w"] * np.float32(0.05)
    last["b"] = last["b"] * np.float32(0.05)
    return ts, jcfg


def test_fleet_holds_against_the_reference_in_distribution():
    ts_np, jcfg = _scaled_jax_state()
    jts = jax.tree.map(jnp.asarray, ts_np)
    jfc = JFleetCfg(ticks_per_slot=5, arrivals_per_user_s=0.5)
    keys = ("requests", "admitted", "p50_s", "p95_s")
    ref = {k: [] for k in keys}
    for seed in range(8):
        r = jsimulate(jts, jcfg, jfc, num_cells=2, seed=seed)
        for k in keys:
            ref[k].append(r[k])
    ts = train_state_from_numpy(ts_np, CFG, device="cpu")
    port = {k: [] for k in keys}
    for seed in range(8):
        r = simulate_fleet(ts, CFG, FCFG, num_cells=2, seed=seed, **CPU)
        assert r["requests"] == r["admitted"] + r["dropped"]
        for k in keys:
            port[k].append(r[k])
    for k in keys:
        med = float(np.median(port[k]))
        assert min(ref[k]) <= med <= max(ref[k]), (k, port[k], ref[k])


def test_a_jax_checkpoint_loads_and_serves(tmp_path):
    ts_np, jcfg = _scaled_jax_state()
    path = jsave(str(tmp_path / "jax.msgpack"),
                 jax.tree.map(jnp.asarray, ts_np))
    ts, _ = load_train_state(path, CFG, device="cpu")
    a = simulate_fleet(ts, CFG, FCFG, num_cells=2, seed=1, **CPU)
    b = simulate_fleet(train_state_from_numpy(ts_np, CFG, device="cpu"),
                       CFG, FCFG, num_cells=2, seed=1, **CPU)
    assert a["requests"] > 0
    for k in ("requests", "admitted", "p50_s", "p99_s", "mean_latency_s"):
        assert a[k] == b[k], k
    np.testing.assert_array_equal(a["hist"], b["hist"])


# -- behaviour (tests/test_fleet.py, mirrored) -------------------------------

@pytest.fixture(scope="module")
def fleet_res(ts_t2drl):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return simulate_fleet(ts_t2drl, CFG, FCFG, num_cells=2, seed=3,
                              **CPU)
    finally:
        torch.set_num_threads(n)


def test_same_seed_pin_and_request_conservation(ts_t2drl, fleet_res):
    again = simulate_fleet(ts_t2drl, CFG, FCFG, num_cells=2, seed=3, **CPU)
    for k in ("requests", "admitted", "dropped", "p50_s", "p99_s",
              "mean_latency_s", "end_backlog_s"):
        assert fleet_res[k] == again[k], k
    np.testing.assert_array_equal(fleet_res["hist"], again["hist"])
    other = simulate_fleet(ts_t2drl, CFG, FCFG, num_cells=2, seed=4, **CPU)
    assert other["requests"] != fleet_res["requests"]
    # every arrival past truncation is admitted or dropped, and every
    # admitted request is one histogram entry: exactly
    assert fleet_res["requests"] == fleet_res["admitted"] \
        + fleet_res["dropped"]
    assert fleet_res["hist"].sum() == fleet_res["admitted"] > 0
    assert fleet_res["backlog_curve"].shape == (2, ENV.T * ENV.K)
    assert fleet_res["peak_backlog_s"] >= fleet_res["mean_backlog_s"] >= 0
    fr = fleet_res["frames"]
    assert fr["frame"] == list(range(ENV.T))
    for t in range(ENV.T):
        assert 0.0 <= fr["drop_rate"][t] <= 1.0
        if not np.isnan(fr["p50_s"][t]):
            assert fr["p50_s"][t] <= fr["p95_s"][t] <= fr["p99_s"][t]


def test_cell_zero_draws_what_a_one_cell_fleet_draws(ts_t2drl):
    """Arrivals do not depend on the actions, and cell 0 draws from the
    same generator in the same order whatever the fleet size."""
    one = twin.fleet_run(*_run_args(ts_t2drl, 1))
    three = twin.fleet_run(*_run_args(ts_t2drl, 3))
    for k in ("arrivals", "truncated"):
        assert int(one[0][k][0]) == int(three[0][k][0]), k
        torch.testing.assert_close(one[3]["counts"][k][0],
                                   three[3]["counts"][k][0], rtol=0, atol=0)


def _run_args(ts, C):
    from repro_torch.core.t2drl import cell_generators, export_policy
    models = type(ts["models"])(*(x.expand((C,) + tuple(x.shape))
                                  for x in ts["models"]))
    return (export_policy(ts, CFG), models, CFG, FCFG,
            cell_generators(7, C, "cpu"))


def test_uncached_requests_take_the_cloud_path():
    env0 = dataclasses.replace(ENV, C=0.0)
    cfg0 = dataclasses.replace(RCARS, env=env0)
    ts = t2drl_init(make_generator(0, "cpu"), cfg0)
    res = simulate_fleet(ts, cfg0, FCFG, num_cells=1, seed=0, **CPU)
    assert res["requests"] > 0
    assert res["dropped"] == res["mean_wait_s"] == 0.0
    assert res["end_backlog_s"] == res["peak_backlog_s"] == 0.0
    assert res["mean_latency_s"] > 0.0


def test_population_scales_offered_load(ts_rcars):
    lo = simulate_fleet(ts_rcars, RCARS, FCFG, num_cells=2, seed=5,
                        user_counts=(1, 1), **CPU)
    hi = simulate_fleet(ts_rcars, RCARS, FCFG, num_cells=2, seed=5,
                        user_counts=(4, 4), **CPU)
    assert hi["requests"] > 2.0 * lo["requests"]


def test_scenario_schedule_is_a_traffic_trace(ts_rcars):
    b = build_scenario("flash-crowd", ENV, num_envs=2, device="cpu")
    res = simulate_fleet(ts_rcars, RCARS, FCFG, num_cells=2, seed=5,
                         mods=b.mods, **CPU)
    base = simulate_fleet(ts_rcars, RCARS, FCFG, num_cells=2, seed=5, **CPU)
    assert res["requests"] != base["requests"]
    assert res["requests"] > 0 and base["requests"] > 0


def test_truncation_is_counted_not_silent(ts_rcars):
    stress = FleetCfg(ticks_per_slot=5, arrivals_per_user_s=50.0,
                      max_arrivals=4)
    res = simulate_fleet(ts_rcars, RCARS, stress, num_cells=1, seed=0, **CPU)
    assert res["truncated"] > 0.0
    assert res["requests"] == res["admitted"] + res["dropped"]


def test_batched_ts_fixes_fleet_size():
    cfg = dataclasses.replace(CFG, policy="shared")
    from repro_torch.core.t2drl import cell_generators
    ts = t2drl_init_batch(cell_generators(0, 2, "cpu"), cfg)
    res = simulate_fleet(ts, cfg, FCFG, seed=0, **CPU)
    assert res["num_cells"] == 2
    with pytest.raises(ValueError, match="batched over 2 cells"):
        simulate_fleet(ts, cfg, FCFG, num_cells=3, seed=0, **CPU)


def test_fleet_needs_a_device_or_an_explicit_cpu(ts_rcars, tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            simulate_fleet(ts_rcars, RCARS, FCFG)
    import json
    from repro_torch.obs import MetricWriter, validate_jsonl
    path = tmp_path / "fleet.jsonl"
    with MetricWriter(str(path)) as w:
        simulate_fleet(ts_rcars, RCARS, FCFG, num_cells=1, seed=0,
                       writer=w, tags={"method": "rcars"}, **CPU)
    assert validate_jsonl(str(path)) == ENV.T + 2
    kinds = [json.loads(line)["kind"] for line in open(path)]
    assert kinds == ["manifest"] + ["fleet_frame"] * ENV.T \
        + ["fleet_summary"]
