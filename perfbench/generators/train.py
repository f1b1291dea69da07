"""The ``train`` generator: B cells' learners trained as one fused program.

Set-up builds the program's train state for B cells
(``t2drl_init_batch``) on generators seeded from the run's seed, and
drives it through whole episodes of ``run_training`` until the first
``checked_steps`` calls of every checked site have been recorded
(``capture.Capture``) and the last episode made as many updates as every
later one will.  The measured window then continues the same state and
the same episode schedule, episode after episode, until ``--seconds``
have passed and an episode has ended on its host read.

The check follows the program's first steps with the plain reference:
the start (each cell's fresh state, drawn again from its seed), the
replay's minibatch draws, the acting chain and the env's slot step of
the first slots, and the first D3PG and DDQN updates: each step's
losses, the first gradient as Adam's moments hold it, and each leaf's
change after the last checked step.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import counts
from perfbench.lib import check, program
from perfbench.lib.capture import Capture
from perfbench.reference import env as renv
from perfbench.reference import nets as rnets
from perfbench.reference import t2drl as rt2

B1 = 0.9     # Adam's first-moment decay in both learners


def _dev(x, device):
    """Recorded tensors back on ``device``; generator states stay on the
    host, where ``Generator.set_state`` takes them."""
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, dict):
        return {k: v if k == "gens" else _dev(v, device)
                for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_dev(v, device) for v in x)
    return x


class Traffic:
    def __init__(self, cell: dict, seed: int, device: torch.device):
        self.file, self.mix = cell["config"], cell["mix"]
        self.device, self.seed = device, int(seed)
        self.B = int(self.mix["cells"])
        self.n_check = int(self.mix["checked_steps"])
        program.f32_only()
        self.cfg = program.t2drl_cfg(self.file, seed, self.mix)
        self.seeds = program.cell_seeds(seed, self.B)
        env = self.cfg.env
        self.per_episode = {"episodes": 1, "slots": env.T * env.K,
                            "updates": env.T * env.K
                            * self.cfg.updates_per_slot,
                            "ddqn_updates": env.T - 1,
                            "cell_slots": self.B * env.T * env.K}
        self.episode_idx, self.sigmas, self.failed = 0, {}, 0

    # -- the program's work --------------------------------------------------

    def setup(self) -> None:
        from repro_torch.core import t2drl_init_batch
        self.gens = program.generators(self.seeds, self.device)
        self.ts = t2drl_init_batch(self.gens, self.cfg)
        self.capture = Capture(self.n_check)
        steady = (self.per_episode["updates"],
                  self.per_episode["ddqn_updates"])
        limit = int(self.mix.get("max_setup_episodes", 50))
        with self.capture:
            while True:
                before = dict(self.capture.calls)
                self.episode()
                made = tuple(self.capture.calls[k] - before[k]
                             for k in ("d3pg", "ddqn"))
                if self.capture.done() and made == steady:
                    break
                if self.episode_idx >= limit:
                    raise RuntimeError(
                        f"set-up reached no steady episode in {limit}: the "
                        f"last made {made} updates, a steady one {steady}")

    def episode(self) -> None:
        """One episode of ``run_training``, at the episode schedule's next
        values; it ends on the program's host read of the stats."""
        from repro_torch.core import (episode_epsilon, episode_sigma,
                                      run_training)
        e = self.episode_idx
        eps = float(episode_epsilon(self.cfg, e))
        sigma = float(episode_sigma(self.cfg, e))
        self.ts, hist = run_training(
            self.ts, self.cfg, self.gens, 1,
            pop={"eps": [eps] * self.B, "sigma": [sigma] * self.B})
        self.sigmas[e] = float(np.float32(sigma))
        bad = ~np.isfinite(np.asarray(hist["episode_reward"][0]))
        self.failed += int(bad.sum()) * self.per_episode["slots"]
        self.episode_idx += 1

    def window(self, seconds: float) -> dict:
        self.failed = 0
        n, t0, ends = 0, time.perf_counter(), []
        while True:
            self.episode()
            n += 1
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        return {"seconds": ends[-1], "failed": self.failed,
                "unit_s": list(np.diff([0.0] + ends)), "learners": self.B,
                **{k: v * n for k, v in self.per_episode.items()}}

    def stretch(self):
        """The traced stretch: one whole episode, and what it holds."""
        return self.episode, {**self.per_episode, "learners": self.B}

    @staticmethod
    def end_to_end(w: dict) -> dict:
        return {"train_cell_slots_per_s": w["cell_slots"] / w["seconds"]}

    @staticmethod
    def attempted(w: dict) -> int:
        return w["cell_slots"]

    def work_flops(self, w: dict) -> float:
        n = counts.nets_of(self.file)
        return w["learners"] * (
            w["slots"] * counts.act(n).flops
            + w["updates"] * counts.d3pg_update(n).flops
            + w["ddqn_updates"] * counts.ddqn_update(n).flops)

    def free(self) -> None:
        self.ts = self.gens = None
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    # -- the check -----------------------------------------------------------

    def readings(self, control: bool = False) -> dict:
        """Each compared number for the program's recorded steps or, with
        ``control``, for the reference itself computed with TF32 products
        in the program's place."""
        dev = self.device
        h = rt2.Hyper(self.file, dev)
        mm = rnets.tf32_matmul if control else torch.matmul
        rec = _dev(self.capture.rec, dev)
        init = rt2.init_cells(program.generators(self.seeds, dev), h)
        out = {"start_gap": 0.0 if control else self._start_gap(rec, init),
               "sample_gap": 0.0 if control else self._sample_gap(rec, h)}
        out.update(self._slots(rec, init, h, mm, control))
        out.update(self._learners(rec, init, h, mm, control))
        return out

    def _start_gap(self, rec, init) -> float:
        d0, q0 = rec["d3pg"][0]["before"], rec["ddqn"][0]["before"]
        pairs = []
        for k, ref in (("actor", "actor"), ("actor_t", "actor"),
                       ("critic", "critic"), ("critic_t", "critic")):
            pairs += zip(d0[k][0] + d0[k][1], init[ref][0] + init[ref][1])
        for k in ("q", "q_target"):
            pairs += zip(q0[k][0] + q0[k][1], init["q"][0] + init["q"][1])
        models = rec["env"][0]["models"]
        pairs += [(models[k], init["models"][k]) for k in init["models"]]
        gap = max(check.max_rel(p, r) for p, r in pairs)
        for o in (d0["opt_a"], d0["opt_c"], q0["opt"]):
            moments = o["mu"] + o["nu"]
            gap = max([gap, float(o["step"] != 0)]
                      + [check.max_abs(m, torch.zeros_like(m))
                         for m in moments])
        return gap

    def _sample_gap(self, rec, h) -> float:
        gap = 0.0
        for r in rec["ebuf"] + rec["fbuf"]:
            ref = rt2.sample(r["data"], r["sizes"], r["gens"], r["n"],
                             h.device)
            gap = max([gap] + [check.max_rel(r["batch"][k], ref[k])
                               for k in ref])
        return gap

    def _slots(self, rec, init, h, mm, control) -> dict:
        """The acting chain's and the env step's gaps over the first
        checked slots (all in episode 0, at its exploration sigma)."""
        act_gap = env_gap = 0.0
        for a, e in zip(rec["act"], rec["env"]):
            st, models = e["state"], e["models"]
            b, xi = rt2.act(init["actor"], a["s"], a["gens"],
                            self.sigmas[0], st["req"], st["rho"], h,
                            torch.matmul)
            if control:
                cb, cxi = rt2.act(init["actor"], a["s"], a["gens"],
                                  self.sigmas[0], st["req"], st["rho"], h, mm)
            else:
                cb, cxi = e["b"], e["xi"]
            act_gap = max(act_gap, check.max_abs(cb, b),
                          check.max_abs(cxi, xi))
            if control:
                continue
            r, nxt = rt2.env_step(st, models, e["b"], e["xi"], e["gens"], h)
            s = renv.observe(st, h.env, models)
            env_gap = max([env_gap, check.loss_gap(e["r"], r),
                           check.max_rel(a["s"], s)]
                          + [check.max_rel(e["next"][k], nxt[k])
                             for k in nxt])
        return {"act_gap": act_gap, "env_gap": env_gap}

    def _learners(self, rec, init, h, mm, control) -> dict:
        """The D3PG and DDQN updates followed from the start for the
        checked steps, on the program's minibatches and draws."""
        zeros = lambda net: [torch.zeros_like(x) for x in  # noqa: E731
                             net[0] + net[1]]
        d3 = {"actor": init["actor"], "actor_t": init["actor"],
              "critic": init["critic"], "critic_t": init["critic"]}
        d3_opt = {k: (zeros(init[k]), zeros(init[k]))
                  for k in ("actor", "critic")}
        dq = {"q": init["q"], "q_target": init["q"]}
        dq_opt = (zeros(init["q"]), zeros(init["q"]))
        ref = {"d3": (d3, d3_opt), "dq": (dq, dq_opt)}
        cand = {"d3": (d3, d3_opt), "dq": (dq, dq_opt)}
        loss_gap, grads, cgrads = 0.0, {}, {}
        for i, (r, q) in enumerate(zip(rec["d3pg"], rec["ddqn"])):
            p, o, losses, g = rt2.d3pg_step(*ref["d3"], i, r["batch"],
                                            r["gens"], h, torch.matmul)
            ref["d3"] = (p, o)
            pq, oq, lq, gq = rt2.ddqn_step(*ref["dq"], i, q["batch"], h,
                                           torch.matmul)
            ref["dq"] = (pq, oq)
            if control:
                cp, co, closs, cg = rt2.d3pg_step(*cand["d3"], i,
                                                  r["batch"], r["gens"], h,
                                                  mm)
                cand["d3"] = (cp, co)
                cpq, coq, clq, cgq = rt2.ddqn_step(*cand["dq"], i,
                                                   q["batch"], h, mm)
                cand["dq"] = (cpq, coq)
            else:
                closs, clq = r["losses"], q["loss"]
                if i == 0:
                    cg = {k: [m / (1 - B1) for m in r["mu"][k]]
                          for k in ("actor", "critic")}
                    cgq = [m / (1 - B1) for m in q["mu"]]
            loss_gap = max(loss_gap, check.loss_gap(closs["critic_loss"],
                                                    losses["critic_loss"]),
                           check.loss_gap(closs["actor_loss"],
                                          losses["actor_loss"]),
                           check.loss_gap(clq, lq))
            if i == 0:
                grads = {"actor": g["actor"], "critic": g["critic"], "q": gq}
                cgrads = {"actor": cg["actor"], "critic": cg["critic"],
                          "q": cgq}
        self.where = {"grad": {k: {} for k in grads},
                      "change": {k: {} for k in grads}}
        grad_gap = max(check.norm_gap(cgrads[k], grads[k],
                                      where=self.where["grad"][k])
                       for k in grads)
        leaves = lambda net: net[0] + net[1]  # noqa: E731
        diff = lambda a, b: [x - y for x, y in  # noqa: E731
                             zip(leaves(a), leaves(b))]
        if control:
            cchange = {"actor": diff(cand["d3"][0]["actor"], init["actor"]),
                       "critic": diff(cand["d3"][0]["critic"],
                                      init["critic"]),
                       "q": diff(cand["dq"][0]["q"], init["q"])}
        else:
            d0, q0 = rec["d3pg"][0]["before"], rec["ddqn"][0]["before"]
            last, lastq = rec["d3pg"][-1]["after"], rec["ddqn"][-1]["after"]
            cchange = {"actor": diff(last["actor"], d0["actor"]),
                       "critic": diff(last["critic"], d0["critic"]),
                       "q": diff(lastq, q0["q"])}
        change = {"actor": diff(ref["d3"][0]["actor"], init["actor"]),
                  "critic": diff(ref["d3"][0]["critic"], init["critic"]),
                  "q": diff(ref["dq"][0]["q"], init["q"])}
        change_gap = max(check.norm_gap(
            cchange[k], change[k], check.moving(grads[k]),
            where=self.where["change"][k]) for k in change)
        return {"loss_gap": loss_gap, "grad_gap": grad_gap,
                "change_gap": change_gap}
