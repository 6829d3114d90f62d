#!/usr/bin/env python3
"""Where the JAX package's plain paths round or truncate, against the port
and the exact result, for the signal and tap types of ROADMAP queue 3.

    JAX_PLATFORMS=cpu python3 tools/reference_faults.py

Runs on the CPU in about half a minute and prints one line a finding:

- integer taps at a rate: JAX ``windows`` casts alpha to the taps' integer
  type (alpha = 0), against the port; both as relative RMS from the exact
  float64 result (the same method with float64 taps);
- float16 taps at a rate: JAX ``windows`` rounds alpha and each
  interpolated tap to float16; JAX ``winsel`` (the TPU kernel, interpret
  mode) and ``windows`` on the same bank widened to float32 do not: each
  as max|dy| / max|y| from the port;
- bfloat16 taps with an int16 signal in the rational family: JAX
  ``windows`` sums in bfloat16; ``supercycle`` does not: each from the
  port;
- integer pairs through JAX ``path="auto"`` at 3//2: int64 taps with an
  int8 signal raise ``TypeError`` (``preferred_element_type`` narrower
  than the operands), and uint16 taps with a uint32 signal return int32
  where ``windows`` (and ``_out_dtype``) give uint32; the port's type and
  values beside, against the exact sum wrapped to the output type;
- a bfloat16 signal against complex taps: JAX ``windows`` against the
  port (complex64 taps, max|dy|/max|y|; complex128 taps raise), beside
  ``supercycle`` (rational) or ``windows`` on the signal widened to
  float32 (at a rate).
"""

import dataclasses
import sys
from fractions import Fraction
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import multirate_tpu as mr  # noqa: E402
import multirate_tpu_torch as mt  # noqa: E402
from multirate_tpu_torch.utils.oracle import naivefilt  # noqa: E402

jax.config.update("jax_enable_x64", True)
RATE, NPHI, N = 0.77, 8, 3000


def _jax(p, x, path):
    y, c, _ = mr.filt_block(p, mr.init_state(p, (), x.dtype),
                            jnp.asarray(x), path=path)
    y = np.asarray(y)[:int(c)]
    return y if np.iscomplexobj(y) else y.astype(np.float64)


def _port(h, x, **kw):
    p = mt.make_kernel(mt.ops.params.to_tensor(h), device="cpu", **kw)
    t = torch.from_numpy(x)
    return mt.filt_block(p, mt.init_state(p, (), t.dtype), t)[0].double(
        ).numpy()


def _rel_rms(y, ref):
    return float(np.sqrt(np.mean((y - ref) ** 2) / np.mean(ref ** 2)))


def _rel_max(y, ref):
    return float(np.abs(y - ref).max() / np.abs(ref).max())


def main():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(N).astype(np.float32)
    proto = mr.firdes(64, 0.4, mr.kaiser, samplerate=NPHI, beta=7.0) * NPHI

    h16 = np.round(proto * 1000).astype(np.int16)
    exact = naivefilt(h16.astype(np.float64), x.astype(np.float64), RATE,
                      NPHI)
    yj = _jax(mr.make_kernel(h16, rate=RATE, nphi=NPHI), x, "windows")
    yp = _port(h16, x, rate=RATE, nphi=NPHI)
    print(f"int16 taps at {RATE}, nphi {NPHI}: relative RMS from the exact "
          f"result, JAX windows {_rel_rms(yj, exact[:len(yj)]):.3e}, the "
          f"port {_rel_rms(yp, exact[:len(yp)]):.3e}")

    hf = proto.astype(np.float16)
    jp = mr.make_kernel(hf, rate=RATE, nphi=NPHI)
    yp = _port(hf, x, rate=RATE, nphi=NPHI)
    widened = dataclasses.replace(jp, pfb=jp.pfb.astype(jnp.float32),
                                  dpfb=jp.dpfb.astype(jnp.float32))
    print(f"float16 taps at {RATE}, nphi {NPHI}: max|dy|/max|y| from the "
          f"port, JAX windows {_rel_max(_jax(jp, x, 'windows'), yp):.3e}, "
          f"JAX winsel {_rel_max(_jax(jp, x, 'winsel'), yp):.3e}, JAX "
          f"windows on the bank in float32 "
          f"{_rel_max(_jax(widened, x, 'windows'), yp):.3e}")

    hb = np.asarray(jnp.asarray(mr.firdes(96, 0.1, mr.kaiser, beta=7.0)
                                * 4, jnp.bfloat16))
    pcm = (rng.standard_normal(N) * 1500).astype(np.int16)
    for ratio in (Fraction(1, 1), Fraction(4, 1), Fraction(1, 4)):
        jr = mr.make_kernel(hb, ratio=ratio)
        yp = _port(hb, pcm, ratio=ratio)
        win = _rel_max(_jax(jr, pcm, "windows"), yp)
        sup = _rel_max(_jax(jr, pcm, "supercycle"), yp)
        print(f"bfloat16 taps, int16 signal, {ratio}: max|dy|/max|y| from "
              f"the port, JAX windows {win:.3e}, JAX supercycle {sup:.3e}")


    ratio = Fraction(3, 2)
    for tap, sig in (("int64", "int8"), ("uint16", "uint32")):
        hi = rng.integers(0, 2 ** 14, 72).astype(tap)
        xi = rng.integers(0, 120, 400).astype(sig)
        jp = mr.make_kernel(hi, ratio=ratio)
        yw = np.asarray(mr.filt_block(jp, mr.init_state(jp, (), xi.dtype),
                                      jnp.asarray(xi), path="windows")[0])
        try:
            ya = np.asarray(mr.filt_block(jp, mr.init_state(jp, (), xi.dtype),
                                          jnp.asarray(xi), path="auto")[0])
            n = min(len(ya), len(yw))
            diff = ya[:n].astype(np.int64) - yw[:n].astype(np.int64)
            auto = (f"{ya.dtype}, {int((diff != 0).sum())} of {n} outputs "
                    f"off windows' values (max |dy| {int(abs(diff).max())})")
        except TypeError as e:
            auto = f"TypeError ({str(e).splitlines()[0][:70]}...)"
        tp = mt.make_kernel(torch.from_numpy(hi), ratio=ratio, device="cpu")
        t = torch.from_numpy(xi)
        y, c, _ = mt.filt_block(tp, mt.init_state(tp, (), t.dtype), t)
        up = np.zeros(len(xi) * 3, dtype=object)
        up[::3] = [int(v) for v in xi]
        exact = np.convolve(up, [int(v) for v in hi])[:len(up)][::2][:c]
        bits = yw.dtype.itemsize * 8
        same = all(int(a) % (1 << bits) == v % (1 << bits)
                   for a, v in zip(y.numpy(), exact))
        print(f"{tap} taps, {sig} signal, {ratio}: JAX auto {auto}; JAX "
              f"windows {yw.dtype}; the port {str(y.dtype)[6:]}, the exact "
              f"sum wrapped to it: {same}")

    xb = np.asarray(jnp.asarray(x, jnp.bfloat16))
    for ctype in (np.complex64, np.complex128):
        hc = (proto * np.exp(0.5j * np.pi * np.arange(len(proto)))).astype(
            ctype)
        for kw, ref in (({"ratio": Fraction(7, 5)}, "supercycle"),
                        ({"rate": RATE, "nphi": NPHI}, "windows on float32")):
            jp = mr.make_kernel(hc, **kw)
            p = mt.make_kernel(torch.from_numpy(hc), device="cpu", **kw)
            t = mt.ops.params.to_tensor(xb)
            yp = mt.filt_block(p, mt.init_state(p, (), t.dtype), t)[0].numpy()
            try:
                win = f"{_rel_max(_jax(jp, xb, 'windows'), yp):.3e}"
            except TypeError:
                win = "TypeError"
            yr = (_jax(jp, xb, "supercycle") if "ratio" in kw
                  else _jax(jp, xb.astype(np.float32), "windows"))
            print(f"bfloat16 signal, {np.dtype(ctype).name} taps, {kw}: "
                  f"max|dy|/max|y| from the port, JAX windows {win}, JAX "
                  f"{ref} {_rel_max(yr, yp):.3e}")


if __name__ == "__main__":
    main()
