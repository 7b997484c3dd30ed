"""The result line, the run without a card, the import check, and a new
cell added as files alone."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness

CELLS = ["x3_frames_fast", "x4_frames_fast", "x3_requests_exact",
         "x3_train_amp_b32"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_shape(trace, tiny):
    r = harness.run_cell("x4_frames_fast", 4, 1.0, trace, device="cpu",
                         traffic_overrides=tiny["x4_frames_fast"])
    line = json.loads(json.dumps(r))
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for row in line["checks"].values():
        assert set(row) == {"value", "limit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        bd = line["breakdown"]
        assert set(bd) == {"device_ops", "idle_gaps"}
        assert all(len(bd[k]) <= 10 for k in bd)
        assert "setup_s" not in line["metrics"]
    else:
        assert set(line["metrics"]) == {"hr_mpix_s", "setup_s"}
        assert all(set(m) == {"value", "unit"}
                   for m in line["metrics"].values())


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_run_without_card_exits_nonzero():
    p = _run(["portbench/run.py", "--workload", "x4_frames_fast", "--seed",
              str(2 ** 31 + 1), "--seconds", "1", "--trace", "0"],
             harness.ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0
    assert not any(ln.startswith("{") for ln in p.stdout.splitlines())


def test_benchmark_files_alone_exit_nonzero(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(["portbench/run.py", "--workload", "x4_frames_fast", "--seed",
              "3", "--seconds", "1", "--trace", "0"], str(tmp_path))
    assert p.returncode != 0
    assert not any(ln.startswith("{") for ln in p.stdout.splitlines())


_LOADED = """
import json, sys
sys.path.insert(0, {root!r})
from portbench import harness
from portbench.tests.conftest import TINY, with_later
for trace in (False, True):
    harness.run_cell({cell!r}, 8, 0.5, trace, device="cpu",
                     traffic_overrides=TINY[{cell!r}], bench=with_later())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


@pytest.mark.parametrize("cell", CELLS)
def test_run_loads_no_jax(cell):
    p = _run(["-c", _LOADED.format(root=harness.ROOT, cell=cell)],
             harness.ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    top = set(json.loads(p.stdout.splitlines()[-1]))
    assert "rusty_sr_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "rusty_sr_tpu"}


def test_reference_loads_no_program():
    code = ("import json, sys; sys.path.insert(0, %r); "
            "import portbench.reference.net, portbench.reference.check; "
            "print(json.dumps(sorted(sys.modules)))" % harness.ROOT)
    p = _run(["-c", code], harness.ROOT)
    assert p.returncode == 0, p.stderr
    names = json.loads(p.stdout)
    assert not any(n.split(".")[0] in ("rusty_sr_tpu_torch", "rusty_sr_tpu",
                                       "jax") for n in names)


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "rusty_sr_tpu_torchx", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "rusty_sr_tpu.params", sys)
    assert harness.forbidden_modules() == ["rusty_sr_tpu"]


_NEW_CELL = """
import json, sys
sys.path.insert(0, {copy!r})
sys.path.append({root!r})
from portbench import harness
assert harness.ROOT == {copy!r}, harness.ROOT
r = harness.run_cell("x4_requests_exact", 2, 1.0, False, device="cpu")
print(json.dumps(r))
"""


def test_new_cell_from_files_alone(tmp_path):
    """A cell added as new files and a new BENCHMARK.json entry runs with
    no harness file changed."""
    copy = tmp_path / "checkout"
    copy.mkdir()
    shutil.copytree(harness.BENCH, copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.benchmark()
    bench["workloads"].append({
        "name": "x4_requests_exact", "config": "rusty_sr_x4",
        "traffic": "requests_tiny_exact", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "x3_requests_exact" in m.get("workloads", []):
            m["workloads"].append("x4_requests_exact")
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = harness.load_json(os.path.join(
        harness.BENCH, "traffic", "requests_png_exact.json"))
    traffic.update(sizes=[[20, 30]], images_per_size=1, tile=16, chunk=4)
    (copy / "portbench" / "traffic" / "requests_tiny_exact.json").write_text(
        json.dumps(traffic))
    (copy / "portbench" / "limits" / "x4_requests_exact.json").write_text(
        json.dumps({"max_code_gap": 1, "mean_code_gap": 0.01}))
    p = _run(["-c", _NEW_CELL.format(copy=str(copy), root=harness.ROOT)],
             str(copy))
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.splitlines()[-1])
    assert r["correct"] and {"request_p95_ms", "request_p50_ms",
                             "setup_s"} <= set(r["metrics"])


@pytest.mark.cuda
def test_cell_on_card(card, tiny):
    r = harness.run_cell("x4_frames_fast", 21, 2.0, False,
                         traffic_overrides=tiny["x4_frames_fast"])
    assert r["correct"] and r["device"]["platform"] == "gpu"
