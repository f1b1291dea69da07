"""Request-level edge-fleet serving twin (DESIGN.md §11), port of
``repro.fleet``: a queueing simulator with tail-latency SLOs, driven by
checkpointed greedy policies."""
from .twin import (FleetCfg, fleet_run, latency_quantiles,  # noqa: F401
                   simulate_fleet, summarize_fleet)
