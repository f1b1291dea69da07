"""Synthetic data (port of ``repro.data``): learnable LM token streams and
the AIGC request workload."""
from .synthetic import (Request, lm_batch_stream, make_lm_batch,  # noqa: F401
                        request_stream)
