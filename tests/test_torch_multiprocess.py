"""Data-parallel training in the port over real processes (gloo on the
CPU), against the JAX package's mesh step and its multi-host CLI
contract (tests/test_parallel.py, tests/test_multihost.py).

Every process is spawned with its own timeout.  Bounds: the loss of one
step rel 1e-5 and the parameters after it atol 1e-6 against JAX's
`make_train_step(cfg, mesh)` on the same global batch of 8, as
`test_dp_train_step_matches_single_device` holds JAX's mesh step to its
single-device step (float32 sums in another order); the ranks'
parameters bit-identical (one all-reduce result, the same Adam update
on every rank).
"""

import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from rusty_sr_tpu.parallel.mesh import make_mesh, shard_batch
from rusty_sr_tpu.train.loop import TrainConfig as JTrainConfig
from rusty_sr_tpu.train.loop import make_train_step as j_make_train_step
from rusty_sr_tpu_torch import cli
from rusty_sr_tpu_torch.params import init_params
from rusty_sr_tpu_torch.utils.imageio import save_image_u8

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300

# One rank of a two-process group: three data-parallel steps on its half
# of each global batch, from the tree in the input file.
WORKER = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from rusty_sr_tpu_torch.train import loop as TL

port, rank, inp, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)
d = np.load(inp)
names = [k[2:] for k in d.files if k.startswith("p_")]
p = {k: torch.tensor(d["p_" + k], requires_grad=True) for k in names}
cfg = TL.TrainConfig(crop=24, batch_size=8)
step, _ = TL.make_train_step(cfg, p, dist.group.WORLD)
res = {}
for s, hr in enumerate(d["hr"]):
    loss, _ = step(torch.from_numpy(hr[4 * rank:4 * rank + 4]))
    if s == 0:
        res["loss1"] = np.float32(float(loss))
        res.update({"p1_" + k: v.detach().numpy().copy()
                    for k, v in p.items()})
res.update({"p3_" + k: v.detach().numpy() for k, v in p.items()})
np.savez(out, **res)
dist.destroy_process_group()
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def env():
    e = dict(os.environ)
    e["PYTHONPATH"] = ROOT + os.pathsep + e.get("PYTHONPATH", "")
    return e


def run_ranks(cmds):
    """Run each command as its own process, all at once; (rc, output)
    per command.  Each gets TIMEOUT seconds, and none outlives the call."""
    procs = [subprocess.Popen(c, cwd=ROOT, env=env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def test_dp_train_step_matches_jax_mesh(tmp_path):
    tree = init_params(0, 3)
    hr = np.random.default_rng(3).random((3, 8, 24, 24, 3), dtype=np.float32)
    inp = str(tmp_path / "in.npz")
    np.savez(inp, hr=hr, **{"p_" + k: v for k, v in tree.items()})
    port = free_port()
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(2)]
    for rc, text in run_ranks([[sys.executable, "-c", WORKER, str(port),
                                str(r), inp, outs[r]] for r in range(2)]):
        assert rc == 0, text
    r0, r1 = (np.load(o) for o in outs)
    for k in tree:    # one all-reduce result, one Adam update everywhere
        for when in ("p1_", "p3_"):
            assert r0[when + k].tobytes() == r1[when + k].tobytes(), k
    assert float(r0["loss1"]) == float(r1["loss1"])

    cfg = JTrainConfig(crop=24, batch_size=8)
    mesh = make_mesh(n_data=8, n_spatial=1)
    step, opt = j_make_train_step(cfg, mesh)
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    pj, _, loss, _ = step(jt, opt.init(jt), shard_batch(mesh, hr[0]))
    assert float(r0["loss1"]) == pytest.approx(float(loss), rel=1e-5)
    for k in tree:
        np.testing.assert_allclose(r0["p1_" + k], np.asarray(pj[k]),
                                   atol=1e-6, err_msg=k)


def training_folder(path, n=4, seed=0):
    rng = np.random.default_rng(seed)
    path.mkdir()
    for i in range(n):
        save_image_u8(str(path / f"t{i}.png"),
                      rng.integers(0, 256, (72, 90, 3), dtype=np.uint8))
    return path


def test_two_process_cli_train(tmp_path):
    """As tests/test_multihost.py::test_two_process_cli_train: the files
    striped two a process, the reference's stdout protocol, validation
    and the .rsr on process 0 alone, a checkpoint that resumes."""
    ti = training_folder(tmp_path / "ti")
    out = tmp_path / "out.rsr"
    port = free_port()

    def cmd(pid, *extra):
        return [sys.executable, "-m", "rusty_sr_tpu_torch.cli", "train",
                str(out), str(ti), "--platform", "cpu", "--crop", "24",
                "--max_steps", "2", "--batch", "4",
                "--ckpt_dir", str(tmp_path / "ck"), "-v", str(ti), "-m", "1",
                "--coordinator", f"127.0.0.1:{port}", "--num_processes", "2",
                "--process_id", str(pid), *extra]

    (rc0, out0), (rc1, out1) = run_ranks([cmd(0), cmd(1)])
    assert rc0 == 0, out0
    assert rc1 == 0, out1
    assert "process 0/2, 2 training files" in out0
    assert "process 1/2, 2 training files" in out1
    assert "Beginning Training" in out0 and "Done" in out0
    assert "Beginning Training" not in out1 and "Done" not in out1
    assert "Validation PSNR:" in out0 and "Validation PSNR:" not in out1
    assert out.stat().st_size == 1_043_676
    from rusty_sr_tpu_torch.train import checkpoint as ck
    path = ck.latest_native(str(tmp_path / "ck"))
    assert path is not None and path.endswith("step_00000002")
    _, opt_state, step = ck.restore_native(path)
    assert step == 2 and opt_state is not None

    # Both ranks resume from it and go on to step 3.
    port = free_port()
    (rc0, out0), (rc1, out1) = run_ranks(
        [cmd(p, "--max_steps", "3", "--resume") for p in range(2)])
    assert rc0 == 0 and rc1 == 0, out0 + out1
    assert "Resumed from" in out0 and "at step 2" in out0
    assert ck.latest_native(str(tmp_path / "ck")).endswith("step_00000003")


def test_train_mesh_runs_local_ranks(tmp_path):
    """``train --mesh data=2`` without the multi-process flags starts two
    local ranks; one protocol on stdout, the same files as above."""
    ti = training_folder(tmp_path / "ti", seed=1)
    out = tmp_path / "out.rsr"
    (rc, text), = run_ranks([[
        sys.executable, "-m", "rusty_sr_tpu_torch.cli", "train", str(out),
        str(ti), "--platform", "cpu", "--crop", "24", "--max_steps", "2",
        "--batch", "4", "--mesh", "data=2", "--ckpt_every", "2",
        "--metrics", str(tmp_path / "m.jsonl")]])
    assert rc == 0, text
    assert text.count("Beginning Training") == 1 and "Done" in text
    assert "process 0/2" in text and "process 1/2" in text
    assert out.stat().st_size == 1_043_676
    assert len(open(tmp_path / "m.jsonl").read().splitlines()) == 2


def test_partial_distributed_flags_error(capsys):
    assert cli.main(["train", "o.rsr", "ti", "--coordinator", "x:1"]) == 2
    assert "needs all of" in capsys.readouterr().err


@pytest.mark.parametrize("flags,msg", [
    (["--batch", "3", "--mesh", "2"], "does not divide"),
    (["--batch", "3", "--coordinator", "h:1", "--num_processes", "2",
      "--process_id", "0"], "does not divide"),
    (["--coordinator", "h:1", "--num_processes", "2", "--process_id", "2"],
     "--process_id"),
    (["--coordinator", "h:1", "--num_processes", "2", "--process_id", "0",
      "--mesh", "4"], "must equal --num_processes")],
    ids=["mesh", "multi", "rank", "mesh-vs-world"])
def test_distributed_flag_errors_exit_2(tmp_path, capsys, flags, msg):
    ti = training_folder(tmp_path / "ti")
    assert cli.main(["train", "--platform", "cpu", str(tmp_path / "o.rsr"),
                     str(ti), *flags]) == 2
    assert msg in capsys.readouterr().err
