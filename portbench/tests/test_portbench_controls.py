"""`correct` comes out false for the lower-precision controls and for a
timed path broken underneath: the harness's look for a chip is skipped
(the runs are on the CPU at tiny sizes) and the rest of a run is driven
as it is on the card."""

import numpy as np
import pytest

from portbench import control, harness


@pytest.mark.parametrize("cell", ["x3_frames_fast", "x4_frames_fast",
                                  "x3_requests_exact"])
def test_serving_control_is_not_correct(cell, tiny, bench):
    r = control.serving_control(cell, 2 ** 31 + 11, 3.0, device="cpu",
                                traffic_overrides=tiny[cell], bench=bench)
    assert not r["correct"], r["checks"]
    # failed by its numbers, not for want of an answer in the window
    assert all(c["value"] is not None for c in r["checks"].values())


def test_training_control_and_faults_are_not_correct(tiny, bench):
    out = control.training_control("x3_train_amp_b32", 2 ** 31 + 11,
                                   device="cpu",
                                   traffic_overrides=tiny["x3_train_amp_b32"],
                                   bench=bench)
    for name in ("control_fp8", "half_batch", "state_unchanged"):
        assert not out[name]["correct"], (name, out[name])
    assert out["state_unchanged"]["numbers"]["delta_gap"] == 1.0


def _altered(fn):
    """Wrap an upscale so that each image it produces has one block
    altered where it is produced."""
    def alter(out):
        out = np.array(out)
        out[:4, :4] ^= 0x40
        return out

    def wrapped(*a, on_image_done=None, **k):
        if on_image_done is None:
            return alter(fn(*a, **k))
        return fn(*a, on_image_done=lambda i, o: on_image_done(i, alter(o)),
                  **k)
    return wrapped


@pytest.mark.parametrize("cell, entry", [
    ("x3_frames_fast", "upscale_batch"), ("x4_frames_fast", "upscale_batch"),
    ("x3_requests_exact", "upscale")])
def test_altered_answer_is_not_correct(cell, entry, tiny, bench,
                                      monkeypatch):
    from rusty_sr_tpu_torch import api
    monkeypatch.setattr(api, entry, _altered(getattr(api, entry)))
    r = harness.run_cell(cell, 2 ** 31 + 13, 3.0, False, device="cpu",
                         traffic_overrides=tiny[cell], bench=bench)
    assert not r["correct"], r["checks"]
    assert all(c["value"] is not None for c in r["checks"].values())


# A batch repeated inside a group leaves the first step as it was and
# moves only the later steps' losses and change, which swing as far in
# sound runs on the card: no compared number catches it (PERF.md section 2).
@pytest.mark.parametrize("fault", sorted(set(control.FAULTS)
                                         - {"repeated_batch"}))
def test_broken_training_step_is_not_correct(fault, tiny, bench):
    r = control.training_run("x3_train_amp_b32", 2 ** 31 + 17, fault,
                             device="cpu",
                             traffic_overrides=tiny["x3_train_amp_b32"],
                             bench=bench)
    assert not r["correct"], (fault, r["numbers"])
