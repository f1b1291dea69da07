"""The training loop's episode semantics on the CPU against the JAX
package: the D3PG and DDQN updates of each episode equal those of the
JAX package's own ``train_t2drl`` run of the same config, read from its
telemetry, exactly; the port's own telemetry run of that config has the
reference run's history keys and update counts; the frame reward stored
for the DDQN subtracts the storage penalty (to 1e-5).  Apart from
``test_torch_train.py`` because the reference runs take two of JAX's
episode compiles."""
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import env as jenv
from repro.core import t2drl as jt2
from repro_torch.core import env as tenv
from repro_torch.core import t2drl as tt2


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests run many small ops, which several
    threads only slow down when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# A learned allocator and the DDQN cacher on a storage budget of 0 (any
# cached model pays Xi), random caching (eps = 1): 30 slots and 9 frame
# transitions an episode, so the D3PG gate opens in episode 2 and the
# DDQN's (more than a batch of 32 stored) in episode 4.
GATE_ENV = dict(U=2, M=3, T=10, K=3, C=0.0)
GATE_KW = dict(allocator="d3pg", cacher="ddqn", warmup=40, L=2,
               eps_start=1.0, eps_end=1.0)


@functools.lru_cache(maxsize=None)
def _reference_run(updates_per_slot, episodes=5):
    """The JAX package's own ``train_t2drl`` on the gate config with its
    telemetry (``ObsCfg(enabled=True, replay=False)``)."""
    cfg = jt2.T2DRLCfg(env=jenv.EnvCfg(**GATE_ENV),
                       updates_per_slot=updates_per_slot,
                       obs=jt2.ObsCfg(enabled=True, replay=False), **GATE_KW)
    return jt2.train_t2drl(cfg, episodes=episodes)


@functools.lru_cache(maxsize=None)
def _reference_updates(updates_per_slot, episodes=5):
    """Per-episode (D3PG optimizer steps, DDQN updates) of the reference
    run, from its telemetry: ``diag/updates`` counts the slots whose
    update gate opened, each of which takes ``updates_per_slot`` steps,
    and ``diag/ddqn_updates`` the DDQN updates.  The totals are held
    against the final optimizer states' step counts of that run."""
    ts, hist = _reference_run(updates_per_slot, episodes)
    slots = np.asarray(hist["diag/updates"]).astype(int)
    dq = np.asarray(hist["diag/ddqn_updates"]).astype(int)
    assert int(ts["d3pg"]["opt_a"]["step"]) == slots.sum() * updates_per_slot
    assert int(ts["d3pg"]["opt_c"]["step"]) == slots.sum() * updates_per_slot
    assert int(ts["ddqn"]["opt"]["step"]) == dq.sum()
    return [(int(n) * updates_per_slot, int(m)) for n, m in zip(slots, dq)]


@pytest.mark.parametrize("updates_per_slot", [1, 2])
def test_update_counts_follow_the_reference_gates(updates_per_slot):
    """The port's D3PG and DDQN updates per episode equal those of the JAX
    package's run of the same config (its telemetry), exactly."""
    want = _reference_updates(updates_per_slot)
    assert want[0] == (0, 0) and want[-1][1] > 0     # both gates opened
    cfg = tt2.T2DRLCfg(env=tenv.EnvCfg(**GATE_ENV),
                       updates_per_slot=updates_per_slot, **GATE_KW)
    g = torch.Generator().manual_seed(0)
    ts = tt2.t2drl_init(g, cfg)
    got, prev = [], (0, 0)
    for step in tt2._training_steps(cfg, len(want)):
        ts, stats = tt2._episode_core(ts, cfg, g, step)
        now = (ts["d3pg"]["opt_a"]["step"], ts["ddqn"]["opt"]["step"])
        assert ts["d3pg"]["opt_c"]["step"] == now[0]
        got.append((now[0] - prev[0], now[1] - prev[1]))
        prev = now
        assert all(np.isfinite(v.item()) for v in stats.values())
    assert got == want


def test_train_t2drl_counts_and_frame_reward_sign(monkeypatch):
    """train_t2drl end to end on the CPU, 2 episodes of the gate config:
    its D3PG updates equal those of the JAX package's first 2 episodes,
    and the frame transitions stored for the DDQN carry mean(slot rewards)
    - Xi when storage is over capacity (C = 0: any cached model violates),
    the erratum-corrected sign."""
    ec = tenv.EnvCfg(**GATE_ENV)
    cfg = tt2.T2DRLCfg(env=ec, **GATE_KW)
    seen = []
    step_slot = tt2.env_step_slot

    def record(state, cfg_, models, b, xi, mask=None, mod=None):
        out = step_slot(state, cfg_, models, b, xi, mask, mod)
        viol = float(torch.sum(state.rho * models.c) > cfg_.C)
        seen.append((out[1].item(), viol))
        return out

    monkeypatch.setattr(tt2, "env_step_slot", record)
    ts, hist = tt2.train_t2drl(cfg, episodes=2, device="cpu")
    assert set(hist) == set(tt2.STAT_KEYS) and len(hist["hit_ratio"]) == 2
    want = _reference_updates(1)[:2]
    assert ts["d3pg"]["opt_a"]["step"] == sum(n for n, _ in want) > 0
    assert ts["ddqn"]["opt"]["step"] == sum(m for _, m in want) == 0
    # the last episode's frame transitions: fbuf rows T-1 .. 2(T-1)-1
    K, T = ec.K, ec.T
    last = seen[-T * K:]
    r_frame = [np.mean([r for r, _ in last[t * K:(t + 1) * K]])
               - last[t * K][1] * ec.Xi for t in range(T)]
    stored = ts["fbuf"]["data"]["r"][T - 1:2 * (T - 1)].numpy()
    np.testing.assert_allclose(stored, r_frame[:T - 1], rtol=1e-5)
    assert any(v for _, v in last)         # the penalty did apply
    pol = tt2.export_policy(ts, cfg)
    assert set(pol) == {"actor", "ddqn"} and pol["actor"] is \
        ts["d3pg"]["actor"]
    out = tt2.eval_t2drl(pol, ts["models"], cfg, episodes=1, device="cpu")
    assert all(np.isfinite(v) for v in out.values())


def test_telemetry_history_follows_the_reference_run():
    """The port's ``train_t2drl`` with the same telemetry (3 episodes of
    the gate config) has exactly the reference run's history keys, its
    ``diag/updates`` and ``diag/ddqn_updates`` per episode, and a
    ``denoise_mag`` of L steps; chip_smoke's copied ``DIAG_KEYS`` are the
    reference's diag keys plus the four replay-occupancy keys that
    ``replay=False`` leaves out."""
    _, jhist = _reference_run(1)
    cfg = tt2.T2DRLCfg(env=tenv.EnvCfg(**GATE_ENV),
                       obs=tt2.ObsCfg(enabled=True, replay=False),
                       **GATE_KW)
    _, hist = tt2.train_t2drl(cfg, episodes=3, device="cpu")
    assert set(hist) == set(jhist)
    for k in ("diag/updates", "diag/ddqn_updates"):
        assert hist[k] == np.asarray(jhist[k])[:3].tolist(), k
    assert hist["diag/updates"][-1] > 0
    assert np.asarray(hist["diag/denoise_mag"]).shape == (3, cfg.L)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    replay = {f"diag/{b}_{k}" for b in ("ebuf", "fbuf")
              for k in ("size", "fill")}
    assert cs.DIAG_KEYS == {k for k in jhist if k.startswith("diag/")} \
        | replay
