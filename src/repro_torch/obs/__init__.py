"""Telemetry (DESIGN.md §15), port of ``repro.obs``: learner taps, JSONL
emission in the ``repro-obs/1`` schema, and profiling hooks."""
from .profiling import (compile_count, compile_events,  # noqa: F401
                        profiler_trace, record_compile, reset_compiles,
                        stage)
from .taps import (ObsCfg, broadcast_diag, combine_updates,  # noqa: F401
                   reduce_update_diag)
from .writer import (REQUIRED_FIELDS, SCHEMA, MetricWriter,  # noqa: F401
                     cfg_hash, progress_line, run_manifest, to_jsonable,
                     validate_jsonl, validate_record)
