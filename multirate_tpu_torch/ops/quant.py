"""int8 quantized filtering with stochastic rounding.

Counterpart of ``multirate_tpu/ops/quant.py``. Taps and signal are int8;
the polyphase kernel's int8 instantiation (``csrc/polyphase.cu``) sums
exact int8 x int8 products into int32 accumulators, so the streaming
chunked == whole invariant holds bit for bit. Scales follow the symmetric
convention ``y_true ~= y_int32 * (x_scale * tap_scale)``. Output
re-quantization for int8 cascades rounds stochastically (unbiased:
E[round(v)] = v).

JAX takes a PRNG ``key`` where the port takes a ``torch.Generator``; the
two give different bits from one seed, so only distributions compare.

Overflow: |acc| <= T * 128 * 127, so a filter with fewer than about 2^17
taps per output is exact in int32 (checked at construction).
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from .api import FIRFilter, _as_signal

__all__ = [
    "quantize_taps", "quantize_signal", "stochastic_round_int8",
    "QuantizedFIRFilter", "filt_int8",
]

_INT8_MAX = 127


def quantize_taps(h, scale: float | None = None):
    """(h_q int8 numpy array, scale): symmetric per-tensor tap quantization.

    ``scale`` defaults to max|h| / 127 (no clipping). Rounding is to
    nearest: taps are quantized once, at design time, where the
    deterministic least-error rounding is right.
    """
    h = np.asarray(h, dtype=np.float64)
    if scale is None:
        m = float(np.max(np.abs(h))) if h.size else 1.0
        scale = (m / _INT8_MAX) if m > 0 else 1.0
    q = np.clip(np.round(h / scale), -_INT8_MAX, _INT8_MAX).astype(np.int8)
    return q, float(scale)


def _scaled(v, scale: float) -> torch.Tensor:
    """v / scale in float32, a true division on every device."""
    v = v.to(torch.float32)
    return v / torch.tensor(scale, dtype=torch.float32, device=v.device)


def stochastic_round_int8(v, generator: torch.Generator) -> torch.Tensor:
    """Unbiased stochastic round of float ``v`` to int8: floor(v + u) with
    u ~ U[0, 1) drawn from ``generator`` (on v's device), clipped to
    [-127, 127]. E[result] == clip(v)."""
    u = torch.rand(v.shape, generator=generator, dtype=torch.float32,
                   device=v.device)
    q = torch.floor(v.to(torch.float32) + u)
    return q.clamp(-_INT8_MAX, _INT8_MAX).to(torch.int8)


def quantize_signal(x, scale: float | None = None, generator=None,
                    device=None):
    """(x_q int8 tensor, scale): quantize a signal block.

    ``scale`` defaults to max|x| / 127. With a ``generator``, rounds
    stochastically (unbiased, the right mode on the data path); without,
    to nearest even (``torch.round``, as ``jnp.round``). A numpy ``x`` goes
    to ``device``, else to the card.
    """
    x = _as_signal(x, device)
    if scale is None:
        m = float(x.abs().max()) if x.numel() else 0.0
        scale = (m / _INT8_MAX) if m > 0 else 1.0
    v = _scaled(x, scale)
    if generator is not None:
        return stochastic_round_int8(v, generator), float(scale)
    q = torch.round(v).clamp(-_INT8_MAX, _INT8_MAX).to(torch.int8)
    return q, float(scale)


class QuantizedFIRFilter:
    """Streaming int8 FIR resampler (rational family: standard, L//1,
    1//M, L//M).

    Holds int8 tap banks and an int8 history; each ``filt`` call takes an
    int8 block (``quantize_signal``) and returns float32
    ``y = acc_int32 * (x_scale * tap_scale)``, or int8 when constructed
    with ``out="int8"`` (stochastic re-quantization for cascades, output
    scale ``self.out_scale``, random numbers from ``generator``, by
    default one seeded with 0x5EED on the stream's device). The stream
    runs where ``FIRFilter`` would: on ``device``, else on its first
    chunk's device.
    """

    def __init__(self, h, ratio, *, x_scale: float, out: str = "f32",
                 out_scale: float | None = None, generator=None,
                 device=None):
        ratio = Fraction(*ratio) if isinstance(ratio, tuple) else \
            Fraction(ratio)
        hq, self.tap_scale = quantize_taps(h)
        # worst-case |acc| = taps_per_output * 128 * 127 must fit int32
        if hq.shape[0] * 128 * 127 >= 2 ** 31:
            raise ValueError(f"{hq.shape[0]} taps overflows int32 "
                             f"accumulation")
        if out not in ("f32", "int8"):
            raise ValueError("out must be 'f32' or 'int8'")
        self._filter = FIRFilter(hq, ratio, device=device)
        self.x_scale = float(x_scale)
        self.y_scale = self.x_scale * self.tap_scale
        self.out = out
        if out == "int8":
            # default output scale: the input's dynamic range through a
            # unity-gain filter
            self.out_scale = float(out_scale if out_scale is not None
                                   else self.x_scale)
            self.generator = generator

    @property
    def params(self):
        return self._filter.params

    @property
    def state(self):
        return self._filter.state

    def filt(self, xq):
        """One streaming block: int8 in, float32 (or int8) out, exactly the
        producible outputs."""
        if not (xq.dtype == torch.int8 if isinstance(xq, torch.Tensor)
                else np.asarray(xq).dtype == np.int8):
            raise TypeError("QuantizedFIRFilter consumes int8 blocks; "
                            "use quantize_signal")
        acc = self._filter.filt(xq)
        y = acc.to(torch.float32) * self.y_scale
        if self.out == "f32":
            return y
        if self.generator is None:
            self.generator = torch.Generator(y.device).manual_seed(0x5EED)
        return stochastic_round_int8(_scaled(y, self.out_scale),
                                     self.generator)


def filt_int8(h, x, ratio, *, generator=None, device=None):
    """One-shot int8 quantized resample of float ``x``: quantize taps and
    signal to int8, filter with exact int32 accumulation, and return the
    dequantized float32 output with the scales: (y, x_scale, tap_scale).
    """
    xq, sx = quantize_signal(x, generator=generator, device=device)
    f = QuantizedFIRFilter(h, ratio, x_scale=sx, device=xq.device)
    return f.filt(xq), sx, f.tap_scale
