"""The comparison that decides ``correct`` fails a broken timed path: the
harness runs on the CPU (its look for a card skipped) with the port's
``FIRFilter.filt``, which both entries drive, broken underneath; and the
control, the signal read in bfloat16, fails too."""

import pytest

from benchmark import run
from benchmark.tests.conftest import SEED, SMALL


def _unchanged_state(orig):
    def filt(self, x):
        state = self.state
        y = orig(self, x)
        if state is not None:
            self.state = state  # the step returns its state unchanged
        return y
    return filt


def _half_left_out(orig):
    def filt(self, x):
        y = orig(self, x).clone()
        if y.dim() == 2:
            y[y.shape[0] // 2:] = 0  # half the channels
        else:
            y[y.shape[-1] // 2:] = 0  # half the samples
        return y
    return filt


def _answers_altered(orig):
    def filt(self, x):
        return orig(self, x) * (1 + 1e-3)
    return filt


def _dropped_output(orig):
    def filt(self, x):
        return orig(self, x)[..., :-1]  # one answer never comes
    return filt


@pytest.mark.parametrize("fault", [_unchanged_state, _half_left_out,
                                   _answers_altered, _dropped_output])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell_name, fault):
    from multirate_tpu_torch import FIRFilter

    monkeypatch.setattr(FIRFilter, "filt", fault(FIRFilter.filt))
    result = run.run_cell(cell_name, SEED, 0.3, False, device="cpu",
                          traffic=SMALL[cell_name])
    assert result["correct"] is False, result["checks"]


def test_the_control_is_not_correct(cell_name):
    result = run.run_cell(cell_name, SEED + 1, 0.3, False, device="cpu",
                          control=True, traffic=SMALL[cell_name])
    assert result["correct"] is False
    err = result["checks"]["max_err"]
    assert err["value"] > 3 * err["limit"]
    assert result["checks"]["count_gap"]["value"] == 0


def test_the_fault_wrapper_changes_nothing_when_sound(monkeypatch):
    """The wrappers' plumbing itself keeps a sound run correct."""
    from multirate_tpu_torch import FIRFilter

    orig = FIRFilter.filt
    monkeypatch.setattr(FIRFilter, "filt", lambda self, x: orig(self, x))
    name = "dat_to_cd.madi_block"
    result = run.run_cell(name, SEED, 0.3, False, device="cpu",
                          traffic=SMALL[name])
    assert result["correct"], result["checks"]
