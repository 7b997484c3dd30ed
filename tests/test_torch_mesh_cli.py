"""The CLI with the mesh's spatial and model axes, on the CPU.

Serving: ``--mesh data=1,spatial=2`` and ``data=1,model=2`` on a single
image, a folder and ``watch --once``, against the same runs without a
mesh: byte-identical (the tiles run once a data index, on the same
device, as JAX's replicas compute the same bytes).  CPU convolutions are
not bit-stable under parallel load, so these run on one thread.

Training: ``train --mesh data=1,spatial=2`` and ``data=1,model=2`` start
two local gloo ranks; their data index is 0, so they crop the batches
that one process crops, and the `.rsr` they write is within JAX's f32
mesh bound (atol 2e-6, tests/test_multichip.py) of the run without a
mesh.  Both resume from the mesh's checkpoint (unsharded) to step 3,
within 1e-5 (the third step measured 2.3e-6 apart on one of 2400
values: Adam's later steps divide by smaller second moments).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rusty_sr_tpu_torch import cli
from rusty_sr_tpu_torch.params import load_rsr_file
from rusty_sr_tpu_torch.utils.imageio import load_image_u8, save_image_u8

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = ["data=1,spatial=2", "data=1,model=2"]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def folder(tmp_path):
    src = tmp_path / "in"
    src.mkdir()
    r = np.random.default_rng(8)
    for i, (h, w) in enumerate(((40, 56), (25, 30))):
        save_image_u8(str(src / f"im{i}.png"),
                      r.integers(0, 256, (h, w, 3), dtype=np.uint8))
    return src


def outputs(path):
    """{name: pixels} of a folder; [pixels] of one image."""
    if path.is_file():
        return [load_image_u8(str(path)).tobytes()]
    return {n: load_image_u8(str(path / n)).tobytes()
            for n in sorted(os.listdir(path))}


@pytest.mark.parametrize("mode", ["image", "folder", "watch"])
@pytest.mark.parametrize("spec", SPECS)
def test_cli_mesh_axes_byte_identical(folder, tmp_path, one_thread, spec,
                                      mode):
    base = ["--platform", "cpu", "-p", "anime", "--tile", "18", "--chunk",
            "2", "--fast"]
    src = folder / "im0.png" if mode == "image" else folder
    if mode == "watch":
        base = ["watch", "--once", *base]
    runs = []
    for flags in ([], ["--mesh", spec]):
        dst = tmp_path / (f"out{len(flags)}" + (".png" if mode == "image"
                                                else ""))
        assert cli.main([*base, *flags, str(src), str(dst)]) == 0
        runs.append(outputs(dst))
    assert runs[0] and runs[1] == runs[0]


def run(argv, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", "rusty_sr_tpu_torch.cli",
                           *argv], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)


@pytest.mark.parametrize("spec", SPECS)
def test_train_mesh_axes_as_local_ranks(tmp_path, spec):
    ti = tmp_path / "ti"
    ti.mkdir()
    r = np.random.default_rng(9)
    for i in range(3):
        save_image_u8(str(ti / f"t{i}.png"),
                      r.integers(0, 256, (60, 75, 3), dtype=np.uint8))
    base = ["train", "--platform", "cpu", "--crop", "48", "--max_steps",
            "2", "--data_workers", "1"]
    one = run([*base, str(tmp_path / "one.rsr"), str(ti)])
    assert one.returncode == 0, one.stdout + one.stderr
    two = run([*base, "--mesh", spec, "--ckpt_every", "2", "--ckpt_dir",
               str(tmp_path / "ck"), str(tmp_path / "two.rsr"), str(ti)])
    text = two.stdout + two.stderr
    assert two.returncode == 0, text
    assert text.count("Beginning Training") == 1 and "Done" in text
    assert "process 0/2" in text and "process 1/2" in text
    assert (tmp_path / "two.rsr").stat().st_size == 1_043_676
    a, b = (load_rsr_file(str(tmp_path / n), 3)
            for n in ("one.rsr", "two.rsr"))
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=0, atol=2e-6, err_msg=k)
    from rusty_sr_tpu_torch.train import checkpoint as ck
    tree, opt_state, step = ck.restore_native(ck.latest_native(
        str(tmp_path / "ck")))
    assert step == 2
    ck.check_adam_state(opt_state, tree)   # the unsharded layout
    # Both resume from that checkpoint to step 3: the mesh takes its
    # shards of the moments, one process all of them.
    import shutil
    shutil.copytree(tmp_path / "ck", tmp_path / "ck1")
    outs = [run([*base, *flags, "--max_steps", "3", "--ckpt_dir",
                 str(tmp_path / ck_dir), "--resume", str(tmp_path / ck_dir),
                 str(tmp_path / rsr), str(ti)])
            for flags, ck_dir, rsr in (([], "ck1", "one3.rsr"),
                                       (["--mesh", spec], "ck", "two3.rsr"))]
    for out in outs:
        assert out.returncode == 0 and "at step 2" in out.stdout, \
            out.stdout + out.stderr
    a, b = (load_rsr_file(str(tmp_path / n), 3)
            for n in ("one3.rsr", "two3.rsr"))
    for k in a:   # a third Adam step on f32 sums in another order
        np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-5, err_msg=k)
