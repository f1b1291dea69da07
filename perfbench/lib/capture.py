"""What the program's first training steps took and gave, for the check.

While set-up drives the program through its first episodes, ``Capture``
wraps five of the program's call sites, looked up by module and name, and
copies to the host what the first ``n`` calls of each take and give: the
acting chain (``actor_act_stacked``), the env's slot step
(``env_step_slot``), the replay's minibatch draw (``buffer_sample_stacked``,
slot and frame buffers apart), the D3PG update (``d3pg_update_stacked``)
and the DDQN update (``ddqn_update_stacked``).  Each call's generators are
copied as their states at entry, so the reference can draw the same
numbers again.  The wrappers call the program's own function with the
same arguments and change nothing it computes; they are taken out before
the measured window.
"""
from __future__ import annotations

import importlib

import torch

SITES = (("repro_torch.agents.allocators", "actor_act_stacked", "act"),
         ("repro_torch.core.t2drl", "env_step_slot", "env"),
         ("repro_torch.core.t2drl", "buffer_sample_stacked", "sample"),
         ("repro_torch.agents.allocators", "d3pg_update_stacked", "d3pg"),
         ("repro_torch.agents.cachers", "ddqn_update_stacked", "ddqn"))


def host(x):
    """A detached host copy of a tensor, or of every tensor in a list,
    tuple or dict."""
    if torch.is_tensor(x):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(host(v) for v in x)
    return x


def gen_states(gens) -> list:
    return [g.get_state() for g in gens]


def net_leaves(module) -> tuple:
    """An MLP-like module's (ws, bs) as host copies (a Denoiser's net)."""
    net = getattr(module, "net", module)
    return (host(list(net.w)), host(list(net.b)))


def _opt(o) -> dict:
    return {"mu": host(o["mu"]), "nu": host(o["nu"]), "step": o["step"]}


class Capture:
    """Records the first ``n`` calls of each site (``SITES``) while
    entered; ``calls[kind]`` counts every call."""

    def __init__(self, n: int = 3):
        self.n = n
        self.rec = {k: [] for k in ("act", "env", "ebuf", "fbuf", "d3pg",
                                    "ddqn")}
        self.calls = {k: 0 for k in self.rec}
        self._saved = []

    def done(self) -> bool:
        return all(len(v) >= self.n for v in self.rec.values())

    def _want(self, kind: str) -> bool:
        self.calls[kind] += 1
        return len(self.rec[kind]) < self.n

    def __enter__(self):
        for mod_name, attr, kind in SITES:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, getattr(self, "_" + kind)(fn))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()

    # -- the wrappers --------------------------------------------------------

    def _act(self, fn):
        def act(actor, cfg, sched, state, generators=None, **kw):
            if not self._want("act"):
                return fn(actor, cfg, sched, state, generators, **kw)
            self.rec["act"].append({"s": host(state),
                                    "gens": gen_states(generators)})
            return fn(actor, cfg, sched, state, generators, **kw)
        return act

    def _env(self, fn):
        def env_step(state, cfg, models, b, xi, mask=None, mod=None):
            if not self._want("env"):
                return fn(state, cfg, models, b, xi, mask, mod)
            r = {"state": {f: host(getattr(state, f)) for f in
                           ("gamma_idx", "lambda_idx", "h", "req", "d_in",
                            "rho")},
                 "models": host(models._asdict()), "b": host(b),
                 "xi": host(xi), "gens": gen_states(state.generator)}
            nxt, reward, m = fn(state, cfg, models, b, xi, mask, mod)
            r["r"] = host(reward)
            r["next"] = {f: host(getattr(nxt, f)) for f in
                         ("lambda_idx", "pos", "h", "req", "d_in")}
            self.rec["env"].append(r)
            return nxt, reward, m
        return env_step

    def _sample(self, fn):
        def sample(buf, generators=None, batch: int = 1, **kw):
            kind = "ebuf" if "req" in buf["data"] else "fbuf"
            if not self._want(kind):
                return fn(buf, generators, batch, **kw)
            top = max(buf["size"])
            r = {"data": {k: host(d[:, :top]) for k, d in
                          buf["data"].items()},
                 "sizes": list(buf["size"]), "n": batch,
                 "gens": gen_states(generators)}
            out = fn(buf, generators, batch, **kw)
            r["batch"] = host(out)
            self.rec[kind].append(r)
            return out
        return sample

    def _d3pg(self, fn):
        def update(params, cfg, sched, batch, generators=None, **kw):
            if not self._want("d3pg"):
                return fn(params, cfg, sched, batch, generators, **kw)
            i = len(self.rec["d3pg"])
            r = {"batch": host(batch), "gens": gen_states(generators)}
            if i == 0:
                r["before"] = {k: net_leaves(params[k]) for k in
                               ("actor", "actor_t", "critic", "critic_t")}
                r["before"].update({k: _opt(params[k])
                                    for k in ("opt_a", "opt_c")})
            new, metrics = fn(params, cfg, sched, batch, generators, **kw)
            r["losses"] = host({k: metrics[k] for k in
                                ("critic_loss", "actor_loss")})
            if i == 0:
                r["mu"] = {"actor": host(new["opt_a"]["mu"]),
                           "critic": host(new["opt_c"]["mu"])}
            if i == self.n - 1:
                r["after"] = {k: net_leaves(new[k])
                              for k in ("actor", "critic")}
            self.rec["d3pg"].append(r)
            return new, metrics
        return update

    def _ddqn(self, fn):
        def update(params, cfg, batch, **kw):
            if not self._want("ddqn"):
                return fn(params, cfg, batch, **kw)
            i = len(self.rec["ddqn"])
            r = {"batch": host(batch)}
            if i == 0:
                r["before"] = {"q": net_leaves(params["q"]),
                               "q_target": net_leaves(params["q_target"]),
                               "opt": _opt(params["opt"])}
            new, out = fn(params, cfg, batch, **kw)
            r["loss"] = host(out if torch.is_tensor(out) else out["loss"])
            if i == 0:
                r["mu"] = host(new["opt"]["mu"])
            if i == self.n - 1:
                r["after"] = net_leaves(new["q"])
            self.rec["ddqn"].append(r)
            return new, out
        return update
