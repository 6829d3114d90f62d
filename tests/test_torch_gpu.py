"""The CUDA polyphase kernel against its plain version on the card.

Marked ``gpu``: it skips without a CUDA device. It imports no JAX, so it
runs on a machine with the card alone:

    python -m pytest -o addopts="" -m gpu tests/test_torch_gpu.py

Tolerance: max|dy| <= 1e-5 * max|y| (the same float32 products, summed in
another order); counts and states exact.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

import multirate_tpu_torch as mt
from multirate_tpu_torch.ops.cuda import polyphase as pp

TOL = 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("ratio,taps_per_phase", [
    (Fraction(147, 160), 24), (Fraction(3, 5), 24), (Fraction(1, 4), 24),
    (Fraction(4, 1), 24), (Fraction(1, 1), 24),
    (Fraction(1000, 999), 30),   # bank read from global memory
    (Fraction(1, 200), 1)])      # tile shrunk to fit its span
def test_kernel_matches_plain_on_gpu(ratio, taps_per_phase):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(5)
    L, M = ratio.numerator, ratio.denominator
    h = rng.standard_normal(taps_per_phase * L * (M if L == 1 else 1)
                            + 3).astype(np.float32)
    p = mt.make_kernel(h, ratio=ratio, device="cuda")
    x = torch.from_numpy(
        rng.standard_normal((2, 30_011)).astype(np.float32)).cuda()
    st = mt.init_state(p, (2,))
    _, _, st = mt.filt_block(p, st, x[:, :777], path="windows")
    before = pp.launches
    yk, ck, sk = mt.filt_block(p, st, x, path="kernel")
    yp, cp, sp = mt.filt_block(p, st, x, path="windows")
    torch.cuda.synchronize()
    assert pp.launches == before + 1
    assert ck == cp == yk.shape[-1]
    assert (sk.phase, sk.deficit) == (sp.phase, sp.deficit)
    assert torch.equal(sk.history, sp.history)
    assert float((yk - yp).abs().max()) <= TOL * float(yp.abs().max())
