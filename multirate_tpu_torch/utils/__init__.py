"""Host-side test oracles and comparison helpers (numpy only)."""

from .oracle import causal_fir, naivefilt
from .testing import assert_close, first_divergence, rms

__all__ = ["causal_fir", "naivefilt", "assert_close", "first_divergence",
           "rms"]
