"""High-level configured resampler models.

The reference's examples/ directory is its "model zoo" (the DAT-to-CD
converter, the arbitrary-rate and Farrow demos); these are the equivalent
pipeline objects. ``MultiChannelResampler`` of the JAX package waits for
the sharding slice (ROADMAP.md, queue 1).
"""

from .resampler import Resampler, DATToCD

__all__ = ["Resampler", "DATToCD"]
