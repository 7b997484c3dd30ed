"""The program's own ``rusty_sr.*`` spans (`rusty_sr_tpu_torch.utils.
profiling.span`) open in every traced slice, since the slice's profiler
records them: the slice reads its kernels, copies and spans as it did
before they existed, so no metric moves for them."""

from types import SimpleNamespace

import pytest

from portbench import harness, tracing


class _Event:
    """A stand-in for one of the profiler's kineto events."""

    def __init__(self, name, device, start, end, annotation=False):
        self._name, self._dev = name, device
        self._s, self._e, self._ann = start, end, annotation

    def name(self):
        return self._name

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def is_user_annotation(self):
        return self._ann


def _read(events):
    sl = tracing.Slice(cuda=False)
    sl.prof = SimpleNamespace(stop=lambda: None, profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    sl.mark = SimpleNamespace(__exit__=lambda *exc: False)
    return sl.stop({"calls": 1, "lr_px": 100})


EVENTS = [
    _Event("portbench.slice", False, 0, 10_000),
    _Event("portbench.upscale_batch", False, 100, 9_900),
    _Event("conv_stage_kernel<192, true>", True, 1_000, 3_000),
    _Event("Memcpy DtoH (Device -> Pinned)", True, 3_000, 3_500),
]
PROGRAM = [
    _Event("rusty_sr.chunk.launch", False, 500, 900),
    _Event("rusty_sr.chunk.scatter", False, 4_000, 8_000),
    _Event("rusty_sr.batch.on_image_done", False, 5_000, 5_100),
    # the card's copies of the ranges: user annotations
    _Event("rusty_sr.chunk.launch", True, 900, 3_100, annotation=True),
    _Event("rusty_sr.chunk.scatter", True, 4_000, 8_000, annotation=True),
]


def test_program_spans_change_no_reading():
    plain, with_program = _read(EVENTS), _read(EVENTS + PROGRAM)
    for r in (plain, with_program):
        assert [k[0] for k in r.kernels] == ["conv_stage_kernel<192, true>"]
        assert [c[0] for c in r.copies] == ["Memcpy DtoH (Device -> Pinned)"]
        assert [s[0] for s in r.spans] == ["upscale_batch"]
    for attr in ("slice_s", "kernels", "copies", "spans", "busy_s",
                 "kernel_busy_s"):
        assert getattr(plain, attr) == getattr(with_program, attr), attr
    assert plain.breakdown() == with_program.breakdown()


@pytest.mark.parametrize("cell", ["x4_frames_fast", "x3_requests_exact"])
def test_traced_run_with_and_without_program_spans(cell, tiny, monkeypatch):
    """A traced CPU run reports the same metrics and labels its idle time
    by the same harness spans whether the program's spans record or are
    guarded off."""
    from rusty_sr_tpu_torch.parallel import tiling
    from rusty_sr_tpu_torch.utils import imageio, native, profiling

    def run():
        r = harness.run_cell(cell, 2 ** 31 + 17, 3.0, True, device="cpu",
                             traffic_overrides=tiny[cell])
        gaps = r["breakdown"]["idle_gaps"]
        return set(r["metrics"]), {lab.split(" (")[0] for lab, _ in gaps}

    on = run()
    for mod in (tiling, native, imageio):
        monkeypatch.setattr(mod, "span", lambda name: profiling._NULL)
    assert run() == on
    assert on[0] and on[1]
    assert all(lab.startswith("idle in ") and "rusty_sr" not in lab
               for lab in on[1])
