"""Agent protocol package (DESIGN.md §12), port of ``repro.agents``.

``Agent`` is the one learner API the two-timescale loop is written
against; ``make_allocator`` / ``make_cacher`` dispatch a method name to its
bundle (the only places agent kinds are branched on); ``vmap_agent`` lifts
an agent to B stacked learners.

Import discipline: the submodules import only ``repro_torch.core``
*submodules*, and ``repro_torch.core.t2drl`` imports ``agents.base`` (no
core dependency) at module level and the factories lazily, so either
package may be imported first.
"""
from .base import (Agent, FrameObs, SlotObs, cell_of,  # noqa: F401
                   no_update, vmap_agent)
from .allocators import (ALLOCATORS, d3pg_allocator, make_allocator,  # noqa: F401
                         rcars_allocator, schrs_allocator)
from .cachers import (CACHERS, classical_cacher,  # noqa: F401
                      ddqn_cacher, make_cacher, random_cacher,
                      static_cacher)
from .compat import (d3pg_init_batch, d3pg_update_batch,  # noqa: F401
                     ddqn_init_batch, ddqn_update_batch)
