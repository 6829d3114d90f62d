"""multirate_tpu_torch: the PyTorch and CUDA port of multirate_tpu.

Streaming polyphase FIR filtering and sample-rate conversion on an NVIDIA
Hopper GPU, with the API and semantics of the JAX package
``multirate_tpu`` (which stays the reference): the single-rate FIR, the
L//1 interpolator, the 1//M decimator, the L//M rational resampler, the
arbitrary-rate resampler and the Farrow resampler, the windowed-sinc
designer, the length and phase algebra, and streaming ``FIRFilter`` state
whose chunked output equals the whole-vector output.

The four rational-family filter types run through one hand-written CUDA
kernel (``ops/cuda/polyphase.py``, ``csrc/polyphase.cu``) and the
arbitrary-rate and Farrow resamplers, channel-major (``filt_block``) or
time-major (``filt_block_tm``), through another (``ops/cuda/resample.py``,
``csrc/resample.cu``) on CUDA tensors; CPU tensors run their plain PyTorch
versions. Every filter type takes float32, float64, complex64 and
complex128 signals and taps, with JAX's output type (the promoted type of
taps and signal); complex values stay interleaved, as torch stores them.
The rational family also runs the quantized modes: bfloat16 taps and
signal (float32 outputs), int8 (exact int32 accumulators, with the
helpers of ``quant``), and bfloat16 or float16 output stores
(``make_kernel(..., store_dtype=)``). At an arbitrary or Farrow rate a
bfloat16 or int8 signal is widened to float32 (float32 outputs).

The runtime around them: ``io`` (the native ring buffer and the
``StreamingResampler`` that feeds fixed blocks from arbitrary chunks, with
checkpoint and resume), ``models`` (the self-designing ``Resampler``, the
``DATToCD`` converter and the sharded ``MultiChannelResampler``),
``utils`` (oracles, checkpoint files, throughput and roofline reports with
the card's copy and expand ceilings from a third hand-written kernel,
``csrc/probe.cu``, the cross-path check, and profiler traces),
``examples`` (the JAX package's example flows) and ``parallel`` (channel
x time sharding over the ranks of a ``torch.distributed`` mesh: a halo
exchange between time blocks and each block's entry state in closed
form).

Entry points run on the card unless the caller names the CPU
(``device="cpu"``) or hands over CPU tensors.

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
    FIRArbitrary,
    FIRFarrow,
    FilterState,
    PHASE_FRAC_BITS,
    PHASE_ONE,
    filt,
    filt_block,
    filt_block_tm,
    init_state,
    inputlength,
    max_outputs,
    nextphase,
    outputlength,
    polyfit,
    quant,
    polyval,
    pfb2pnfb,
    reset,
    setphase,
    taps2pfb,
    tapsforphase,
)

from . import io, models, parallel, utils

__version__ = "0.1.0"

__all__ = [
    "FIRResponse", "LOWPASS", "BANDPASS", "HIGHPASS", "BANDSTOP",
    "firdes", "firdes_remez", "firprototype", "kaiserlength",
    "kaiser", "hanning", "hamming", "blackman", "rect",
    "make_kernel",
    "FIRFilter", "FIRStandard", "FIRInterpolator", "FIRDecimator",
    "FIRRational", "FIRArbitrary", "FIRFarrow", "FilterState",
    "PHASE_FRAC_BITS", "PHASE_ONE",
    "filt", "filt_block", "filt_block_tm", "init_state",
    "inputlength", "max_outputs",
    "nextphase", "outputlength", "polyfit", "polyval", "pfb2pnfb", "reset",
    "setphase", "taps2pfb", "tapsforphase", "quant", "io", "models",
    "parallel", "utils",
]
