"""Rational-family operations: kernels, index algebra, block compute, API."""

from .params import (
    FIRStandard,
    FIRInterpolator,
    FIRDecimator,
    FIRRational,
    FilterState,
    init_state,
    make_kernel,
)
from .pfb import taps2pfb, polyfit, polyval, pfb2pnfb
from .api import (
    filt,
    filt_block,
    FIRFilter,
    setphase,
    reset,
    outputlength,
    inputlength,
    nextphase,
    max_outputs,
)

__all__ = [
    "FIRStandard", "FIRInterpolator", "FIRDecimator", "FIRRational",
    "FilterState", "init_state", "make_kernel",
    "taps2pfb", "polyfit", "polyval", "pfb2pnfb",
    "filt", "filt_block", "FIRFilter", "setphase", "reset",
    "outputlength", "inputlength", "nextphase", "max_outputs",
]
