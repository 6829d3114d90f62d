"""File-to-file WAV sample-rate conversion through the streaming runtime.

The production-shaped pipeline the reference leaves to the user (its
examples loop over filt calls on in-memory vectors): int16 PCM WAV in ->
native SPSC ring (int16 -> f32 conversion in C++) -> fixed blocks through
``filt_block`` on the card with state carry -> int16 PCM WAV out, with an
exact sub-block ``flush`` tail. Defaults to the DAT->CD 147//160
conversion (reference examples/DAT to CD.jl) but accepts any rational or
arbitrary rate.

Usage (python -m multirate_tpu_torch.examples.wav_resample ...):
    wav_resample in.wav out.wav [L/M | rate]
    wav_resample --demo          # self-generate + convert
"""

import os
import sys
import tempfile
import wave
from fractions import Fraction

import numpy as np

import multirate_tpu_torch as mt
from multirate_tpu_torch.io import StreamingResampler


def design(ratio) -> np.ndarray:
    """Unity-gain anti-aliasing lowpass for the given conversion ratio."""
    if isinstance(ratio, Fraction):
        L, M = ratio.numerator, ratio.denominator
    else:
        n_phases = 32
        L, M = n_phases, max(1, round(n_phases / float(ratio)))
    cutoff = 0.5 / max(L, M)
    h = mt.firdes(24 * L, cutoff, mt.kaiser, beta=7.8562) * L
    return h.astype(np.float32)


def convert(in_path: str, out_path: str, ratio, chunk: int = 1 << 14,
            device=None):
    """Convert ``in_path`` (mono int16 PCM) to ``out_path`` at ``ratio``
    (a Fraction or a float rate) on ``device``, by default the card;
    returns the float32 output samples."""
    with wave.open(in_path, "rb") as win:
        if win.getsampwidth() != 2 or win.getnchannels() != 1:
            raise ValueError("mono int16 PCM only (batch dims: use the API)")
        fs_in = win.getframerate()
        pcm = win.readframes(win.getnframes())
    x = np.frombuffer(pcm, dtype=np.int16)

    if isinstance(ratio, Fraction):
        f = mt.FIRFilter(design(ratio), ratio, device=device)
        fs_out = int(round(fs_in * ratio.numerator / ratio.denominator))
    else:
        f = mt.FIRFilter(design(ratio), float(ratio), 32, device=device)
        fs_out = int(round(fs_in * float(ratio)))

    s = StreamingResampler(f, block_size=1 << 16)
    out = []
    for i in range(0, len(x), chunk):           # arbitrary-sized chunks:
        part = x[i:i + chunk]
        while part.size:                        # push() reports how many
            n = s.push(part)                    # samples the ring took —
            part = part[n:]                     # re-offer any shortfall
            out.append(s.pull())                # (pull frees ring space)
    out.append(s.flush())                       # exact sub-block tail
    y = np.concatenate([o for o in out if o.size])

    # the native ring normalizes int16 to [-1, 1); scale back on write
    yq = np.clip(np.round(y * 32768.0), -32768, 32767).astype(np.int16)
    with wave.open(out_path, "wb") as wout:
        wout.setnchannels(1)
        wout.setsampwidth(2)
        wout.setframerate(fs_out)
        wout.writeframes(yq.tobytes())
    st = s.stats()
    print(f"{in_path} ({fs_in} Hz, {len(x)} frames) -> "
          f"{out_path} ({fs_out} Hz, {len(yq)} frames) on {s.device}; "
          f"{st['blocks']} blocks, {st['consumed_samples']} in / "
          f"{st['produced_samples']} out")
    return y


def demo(device=None) -> float:
    """Write a 2 s, 48 kHz, 1 kHz tone of amplitude 0.5, convert it to
    44.1 kHz, and return the recovered 1 kHz amplitude (0.45-0.55, else
    raise)."""
    fs = 48_000
    t = np.arange(fs * 2) / fs
    tone = (0.5 * np.sin(2 * np.pi * 1000.0 * t) * 32767).astype(np.int16)
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "demo48k.wav")
        with wave.open(src, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(fs)
            w.writeframes(tone.tobytes())
        y = convert(src, os.path.join(tmp, "demo44k.wav"),
                    Fraction(147, 160), device=device)
    # the 1 kHz tone must survive the conversion
    n = len(y)
    t2 = np.arange(n) / 44_100.0
    proj = np.hypot(np.dot(y, np.sin(2 * np.pi * 1000.0 * t2)),
                    np.dot(y, np.cos(2 * np.pi * 1000.0 * t2))) * 2 / n
    print(f"recovered 1 kHz amplitude: {proj:.3f} (expected ~0.5)")
    if not 0.45 < proj < 0.55:
        raise RuntimeError(f"1 kHz amplitude {proj:.3f} outside 0.45-0.55")
    return float(proj)


def main(argv=None, device=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--demo":
        return demo(device)
    if len(argv) < 2:
        print(__doc__)
        return None
    spec = argv[2] if len(argv) > 2 else "147/160"
    ratio = (Fraction(spec) if "/" in spec or spec.isdigit()
             else float(spec))
    return convert(argv[0], argv[1], ratio, device=device)


if __name__ == "__main__":
    main()
