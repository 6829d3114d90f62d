"""multirate_tpu_torch: the PyTorch and CUDA port of multirate_tpu.

Streaming polyphase FIR filtering and rational sample-rate conversion on an
NVIDIA Hopper GPU, with the API and semantics of the JAX package
``multirate_tpu`` (which stays the reference): the single-rate FIR, the
L//1 interpolator, the 1//M decimator and the L//M rational resampler,
the windowed-sinc designer, the length and phase algebra, and streaming
``FIRFilter`` state whose chunked output equals the whole-vector output.

All four filter types run through one hand-written CUDA kernel
(``ops/cuda/polyphase.py``, ``csrc/polyphase.cu``) on CUDA tensors, and
through its plain PyTorch version on CPU tensors. Arbitrary-rate and
Farrow resampling, the quantized modes, complex and float64 signals,
streaming I/O and sharding are not ported yet (ROADMAP.md, queue 1).

This package imports torch and numpy only, never JAX.
"""

from .design import (
    FIRResponse,
    LOWPASS,
    BANDPASS,
    HIGHPASS,
    BANDSTOP,
    firdes,
    firdes_remez,
    firprototype,
    kaiserlength,
    kaiser,
    hanning,
    hamming,
    blackman,
    rect,
)
from .ops import (
    make_kernel,
    FIRFilter,
    FIRStandard,
    FIRInterpolator,
    FIRDecimator,
    FIRRational,
    FilterState,
    filt,
    filt_block,
    init_state,
    inputlength,
    max_outputs,
    nextphase,
    outputlength,
    polyfit,
    polyval,
    pfb2pnfb,
    reset,
    setphase,
    taps2pfb,
)

__version__ = "0.1.0"

__all__ = [
    "FIRResponse", "LOWPASS", "BANDPASS", "HIGHPASS", "BANDSTOP",
    "firdes", "firdes_remez", "firprototype", "kaiserlength",
    "kaiser", "hanning", "hamming", "blackman", "rect",
    "make_kernel",
    "FIRFilter", "FIRStandard", "FIRInterpolator", "FIRDecimator",
    "FIRRational", "FilterState",
    "filt", "filt_block", "init_state",
    "inputlength", "max_outputs",
    "nextphase", "outputlength", "polyfit", "polyval", "pfb2pnfb", "reset",
    "setphase", "taps2pfb",
]
