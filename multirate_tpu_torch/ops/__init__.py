"""Operations: kernels, index algebra, block compute, API."""

from .params import (
    FIRStandard,
    FIRInterpolator,
    FIRDecimator,
    FIRRational,
    FIRArbitrary,
    FIRFarrow,
    FilterState,
    PHASE_FRAC_BITS,
    PHASE_ONE,
    init_state,
    make_kernel,
)
from .pfb import taps2pfb, polyfit, polyval, pfb2pnfb
from .compute import filt_block_raw, filt_block_tm_raw
from .api import (
    filt,
    filt_block,
    filt_block_inplace,
    filt_block_tm,
    FIRFilter,
    setphase,
    reset,
    tapsforphase,
    outputlength,
    inputlength,
    nextphase,
    max_outputs,
)
from . import quant

__all__ = [
    "FIRStandard", "FIRInterpolator", "FIRDecimator", "FIRRational",
    "FIRArbitrary", "FIRFarrow", "FilterState", "PHASE_FRAC_BITS",
    "PHASE_ONE", "init_state", "make_kernel",
    "taps2pfb", "polyfit", "polyval", "pfb2pnfb",
    "filt", "filt_block", "filt_block_inplace", "filt_block_raw",
    "filt_block_tm",
    "filt_block_tm_raw", "FIRFilter", "setphase", "reset",
    "tapsforphase",
    "outputlength", "inputlength", "nextphase", "max_outputs", "quant",
]
