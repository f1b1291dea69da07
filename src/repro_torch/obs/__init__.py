"""Telemetry (DESIGN.md §15), port of ``repro.obs``: learner taps, JSONL
emission in the ``repro-obs/1`` schema, and profiling hooks (the span
recorder, a ``torch.profiler`` trace, the build counter)."""
from .profiling import (Span, SpanLog, compile_count,  # noqa: F401
                        compile_events, profiler_trace, record_compile,
                        recording, reset_compiles, span, stage, take)
from .taps import (ObsCfg, broadcast_diag, combine_updates,  # noqa: F401
                   reduce_update_diag)
from .writer import (REQUIRED_FIELDS, SCHEMA, MetricWriter,  # noqa: F401
                     cfg_hash, progress_line, run_manifest, to_jsonable,
                     validate_jsonl, validate_record)
