"""High-level configured resampler models.

The reference's examples/ directory is its "model zoo" (the DAT-to-CD
converter, the arbitrary-rate and Farrow demos); these are the equivalent
pipeline objects; ``MultiChannelResampler`` runs its channels and time
blocks sharded over the ranks of a ``torch.distributed`` mesh.
"""

from .resampler import Resampler, DATToCD, MultiChannelResampler

__all__ = ["Resampler", "DATToCD", "MultiChannelResampler"]
