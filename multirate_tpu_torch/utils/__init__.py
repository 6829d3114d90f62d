"""Utilities: naive test oracles, testing helpers, checkpointing,
metrics, debug checks, profiling."""

# the tracer first, and light: the span sites of ``ops`` and ``io`` import
# it while this package (whose other modules import ``ops``) still loads
from .profiling import trace, annotate
from .oracle import causal_fir, naivefilt
from .testing import assert_close, first_divergence, rms
from .checkpoint import save_state, load_state, state_to_host, state_from_host
from .metrics import (ThroughputReport, measure, measure_chained,
                      hbm_roofline_samples_per_s)
from .debug import check_block, check_indices

__all__ = [
    "causal_fir", "naivefilt", "assert_close", "first_divergence", "rms",
    "save_state", "load_state", "state_to_host", "state_from_host",
    "ThroughputReport", "measure", "measure_chained",
    "hbm_roofline_samples_per_s",
    "check_block", "check_indices",
    "trace", "annotate",
]
