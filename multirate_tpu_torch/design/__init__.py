"""Filter design layer (L3 in SURVEY.md): windows, windowed-sinc FIR design.

Reference counterpart: Multirate.jl src/FIRDesign.jl (whole file) plus the
window functions the reference pulls in from DSP.Windows
(Multirate.jl src/Multirate.jl:9-13).
"""

from .windows import kaiser, hanning, hamming, blackman, rect
from .firdes import (
    FIRResponse,
    LOWPASS,
    BANDPASS,
    HIGHPASS,
    BANDSTOP,
    firdes,
    firdes_remez,
    firprototype,
    kaiserlength,
)

__all__ = [
    "kaiser", "hanning", "hamming", "blackman", "rect",
    "FIRResponse", "LOWPASS", "BANDPASS", "HIGHPASS", "BANDSTOP",
    "firdes", "firdes_remez", "firprototype", "kaiserlength",
]
