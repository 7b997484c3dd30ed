"""The port's training loop, checkpoints, `train_folder` and ``train``
command on the CPU, against the JAX package's where both run:

- `validation_psnr` (the port's tiled exact tier against JAX's) to 1e-4
  dB;
- `.rsr` checkpoints byte-identical to the JAX writer's and read back by
  the JAX loader to the same values;
- `train_loop` against JAX's for a few steps from the same init and
  batches, parameters to atol 1e-4 (Adam's f32 noise, as in
  tests/test_torch_train_step.py);
- the cadence, resume and checkpoint cases of tests/test_train.py and
  tests/test_checkpoint.py;
- the CLI's exit codes and messages for bad flags, equal to `rusty-sr
  train`'s.

Width-8 parameters and 12-24 px crops keep each test to seconds.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rusty_sr_tpu import cli as j_cli
from rusty_sr_tpu import params as JP
from rusty_sr_tpu.train import loop as JL
from rusty_sr_tpu_torch import api, cli
from rusty_sr_tpu_torch import params as P
from rusty_sr_tpu_torch.train import checkpoint as ck
from rusty_sr_tpu_torch.train import loop as TL
from rusty_sr_tpu_torch.utils.imageio import save_image_u8

QUIET = lambda s: None  # noqa: E731


def small(seed=0, f=3):
    return P.init_params(seed, f, width=8)


def batches(n, seed=0, crop=12, bsz=4):
    r = np.random.default_rng(seed)
    return [r.integers(0, 256, (bsz, crop, crop, 3), dtype=np.uint8)
            for _ in range(n)]


def cfg(**kw):
    kw.setdefault("crop", 12)
    return TL.TrainConfig(**kw)


def run(n_steps, bs, **kw):
    kw.setdefault("log", QUIET)
    kw.setdefault("start_params", small())
    return TL.train_loop(kw.pop("config", cfg()), iter(bs),
                         max_steps=n_steps, device="cpu", **kw)


@pytest.mark.parametrize("linear", [False, True], ids=["srgb", "linear"])
def test_validation_psnr_matches_jax(linear):
    r = np.random.default_rng(3)
    imgs = [r.random((37, 50, 3), dtype=np.float32),
            r.random((24, 21, 3), dtype=np.float32)]
    tree = P.load_builtin("anime")
    c = dict(linear_loss=linear)
    got = TL.validation_psnr(tree, imgs, TL.TrainConfig(**c), tile=16,
                             device="cpu")
    want = JL.validation_psnr({k: jnp.asarray(v) for k, v in tree.items()},
                              imgs, JL.TrainConfig(**c), tile=16)
    assert abs(got - want) <= 1e-4
    rand = TL.validation_psnr(small(1), imgs, TL.TrainConfig(**c), tile=16,
                              device="cpu")
    assert np.isfinite(rand) and rand != got


def test_rsr_byte_identical_to_jax_writer(tmp_path):
    tree = P.init_params(4, 3)
    P.save_rsr_file(str(tmp_path / "t.rsr"), tree, 3)
    JP.save_rsr_file(str(tmp_path / "j.rsr"), tree, 3)
    data = (tmp_path / "t.rsr").read_bytes()
    assert len(data) == 1_043_676
    assert data == (tmp_path / "j.rsr").read_bytes()
    back = JP.load_rsr_file(str(tmp_path / "t.rsr"), 3)
    for k in tree:
        assert back[k].tobytes() == tree[k].tobytes()
    ck.save_rsr(str(tmp_path / "w8.rsr"), small(), 3)   # width from the tree
    assert os.path.getsize(tmp_path / "w8.rsr") == 4 + 8 * 13051


def test_train_loop_matches_jax_train_loop():
    """Six steps from the same init and u8 batches (singles, then one
    group of steps_per_dispatch=5): the port and the JAX loop agree."""
    bs = batches(6, seed=1)
    tree = small(2)
    c = dict(crop=12, checkpoint_every=5, steps_per_dispatch=5)
    got = TL.train_loop(TL.TrainConfig(**c), iter(bs), start_params=tree,
                        max_steps=6, log=QUIET, device="cpu")
    want = JL.train_loop(JL.TrainConfig(**c), iter(bs), start_params=tree,
                         max_steps=6, log=QUIET)
    for k in tree:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0,
                                   atol=1e-4, err_msg=k)


def test_native_checkpoint_roundtrip_and_keys(tmp_path):
    tree = small()
    p = {k: torch.tensor(v, requires_grad=True) for k, v in tree.items()}
    opt = TL.make_optimizer(cfg(), p)
    TL.train_step(p, opt, torch.from_numpy(batches(1)[0]), cfg())
    ck.save_native(str(tmp_path / "full"), 42, tree, opt.state_dict())
    ck.save_native(str(tmp_path / "bare"), 7, tree)
    path = ck.latest_native(str(tmp_path / "full"))
    assert path.endswith("step_00000042")
    got, st, step = ck.restore_native(path, tree)
    assert step == 42 and st is not None
    for k in tree:
        assert got[k].tobytes() == tree[k].tobytes()
    assert "opt_state" in ck.checkpoint_keys(path)
    assert "opt_state" not in ck.checkpoint_keys(
        ck.latest_native(str(tmp_path / "bare")))
    with pytest.raises(ValueError, match="shapes"):
        ck.restore_native(path, P.init_params(0, 2, width=8))


def test_latest_native_skips_temporary_files(tmp_path):
    """A crash mid-save leaves ``step_N.tmp-<pid>`` (or a directory of
    another writer's) beside the complete checkpoints; it sorts last and
    must not be resumed from."""
    ck.save_native(str(tmp_path), 100, small())
    (tmp_path / "step_00000200.tmp-1735").write_bytes(b"half")
    (tmp_path / "step_00000300.orbax-checkpoint-tmp-1").mkdir()
    assert ck.latest_native(str(tmp_path)).endswith("step_00000100")
    assert ck.latest_native(str(tmp_path / "none")) is None


def test_cadences_and_final_off_cadence_rsr(tmp_path):
    """val_every=2 / checkpoint_every=4 over 5 steps: validation at 1, 2
    and 4; checkpoints at 1 and 4 and the final one at 5; the .rsr holds
    the final parameters."""
    val = [np.random.default_rng(2).random((12, 12, 3), dtype=np.float32)]
    logs = []
    mf = tmp_path / "m.jsonl"
    final = run(5, batches(5), config=cfg(checkpoint_every=4, val_every=2),
                val_images=val, native_ckpt_dir=str(tmp_path / "ck"),
                param_file=str(tmp_path / "out.rsr"), metrics_file=str(mf),
                log=logs.append)
    assert sum("Validation PSNR" in s for s in logs) == 3
    assert sorted(os.listdir(tmp_path / "ck")) == [
        "step_00000001", "step_00000004", "step_00000005"]
    recs = [json.loads(ln) for ln in mf.read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2, 4]
    assert all("val_psnr" in r and np.isfinite(r["loss"]) for r in recs)
    got = ck.restore_native(ck.latest_native(str(tmp_path / "ck")))[0]
    data = (tmp_path / "out.rsr").read_bytes()
    flat = P.decode_rsr(data)
    for k in final:
        assert got[k].tobytes() == final[k].tobytes()
    assert flat.tobytes() == P.pytree_to_flat(final, 3, 8).tobytes()


def test_validate_flag_drives_cadence_without_images(tmp_path):
    mf = tmp_path / "m.jsonl"
    run(3, batches(3), config=cfg(checkpoint_every=100, val_every=1),
        validate=True, metrics_file=str(mf))
    recs = [json.loads(ln) for ln in mf.read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2, 3]
    assert all("val_psnr" not in r for r in recs)


def test_dispatch_groups(monkeypatch):
    """steps_per_dispatch=4, checkpoint_every=4, 9 steps: steps 5-8 run as
    one group over a (4, B, ...) upload, the other five one by one."""
    calls = {"group": [], "single": 0}
    real_group, real_single = TL.train_steps, TL.train_step

    def spy_group(step, hrs):
        calls["group"].append(int(hrs.shape[0]))
        return real_group(step, hrs)

    def spy_single(p, opt, hr, c):
        calls["single"] += 1
        return real_single(p, opt, hr, c)

    monkeypatch.setattr(TL, "train_steps", spy_group)
    monkeypatch.setattr(TL, "train_step", spy_single)
    run(9, batches(9), config=cfg(checkpoint_every=4, steps_per_dispatch=4))
    assert calls["group"] == [4]
    assert calls["single"] == 5 + 4    # the group's four steps call it too


def test_resume_continues_like_an_unbroken_run(tmp_path):
    bs = batches(10, seed=3)
    c = cfg(checkpoint_every=3)
    full = run(10, bs, config=c, seed=7, start_params=None)
    ck_dir = str(tmp_path / "ck")
    run(6, bs, config=c, seed=7, start_params=None, native_ckpt_dir=ck_dir)
    logs = []
    resumed = run(10, bs[6:], config=c, seed=7, start_params=None,
                  resume_from=ck_dir, log=logs.append)
    assert any("Resumed from" in s and "step 6" in s for s in logs)
    for k in full:
        np.testing.assert_allclose(resumed[k], full[k], rtol=0, atol=1e-6)
    p6 = ck.restore_native(ck.latest_native(ck_dir))[0]
    fresh = run(4, bs[6:], config=c, start_params=p6)
    assert max(float(np.abs(fresh[k] - full[k]).max()) for k in full) > 1e-6


def test_resume_missing_empty_params_only_and_incompatible(tmp_path):
    with pytest.raises(RuntimeError, match="no native checkpoint"):
        run(1, [], resume_from=str(tmp_path / "nope"))
    empty = tmp_path / "ck"
    empty.mkdir()
    logs = []
    run(2, batches(2), config=cfg(checkpoint_every=2),
        resume_from=str(empty), native_ckpt_dir=str(empty), log=logs.append)
    assert any("starting fresh" in s for s in logs)
    logs = []
    run(3, batches(1), resume_from=str(empty), log=logs.append)
    assert any("Resumed from" in s for s in logs)

    bare = tmp_path / "bare"
    ck.save_native(str(bare), 2, small())
    logs = []
    assert run(4, batches(2), resume_from=str(bare), log=logs.append)
    assert any("no optimizer state" in s for s in logs)
    bogus = tmp_path / "bogus"
    ck.save_native(str(bogus), 2, small(), {"bogus": torch.zeros(3)})
    with pytest.raises(RuntimeError, match="incompatible|unreadable"):
        run(3, [], resume_from=str(bogus))
    wrong = tmp_path / "wrong"
    ck.save_native(str(wrong), 2, P.init_params(0, 2, width=8))
    with pytest.raises(RuntimeError, match="incompatible"):
        run(3, [], resume_from=str(wrong))
    (tmp_path / "junk").mkdir()
    (tmp_path / "junk" / "step_00000001").write_bytes(b"not a checkpoint")
    with pytest.raises(RuntimeError, match="unreadable"):
        run(3, [], resume_from=str(tmp_path / "junk"))


@pytest.fixture
def folder(tmp_path):
    d = tmp_path / "ti"
    d.mkdir()
    r = np.random.default_rng(0)
    for i in range(3):
        save_image_u8(str(d / f"i{i}.png"),
                      r.integers(0, 256, (40, 45, 3), dtype=np.uint8))
    return str(d)


def test_cli_train_resume_and_rsr(folder, tmp_path, capsys):
    out, ckd = str(tmp_path / "out.rsr"), str(tmp_path / "ck")
    base = ["train", "--platform", "cpu", "--crop", "24", "--ckpt_every",
            "2"]
    assert cli.main(base + [out, folder, "-v", folder, "-m", "1",
                            "--max_steps", "3", "--ckpt_dir", ckd]) == 0
    text = capsys.readouterr().out
    assert text.startswith("Beginning Training\n")
    assert "Validation PSNR:\t" in text and text.endswith("Done\n")
    assert os.path.getsize(out) == 1_043_676
    JP.load_rsr_file(out, 3)                 # the JAX loader reads it
    assert sorted(os.listdir(ckd)) == ["step_00000001", "step_00000002",
                                       "step_00000003"]
    assert cli.main(base + [out, folder, "--resume", ckd, "--max_steps",
                            "5", "--amp"]) == 0
    assert "Resumed from" in capsys.readouterr().out
    assert cli.main(base + [str(tmp_path / "p.rsr"), folder, "-s", out,
                            "--max_steps", "1", "--trunk", "packed",
                            "--remat", "--batch", "2"]) == 0


BAD = [(["-m", "2"], "--val_max requires --val_folder"),
       (["--resume"], "--resume without a DIR requires --ckpt_dir"),
       (["--resume", "ck", "-s", "x.rsr"], "--resume conflicts with"),
       (["--ckpt_every", "0"], "--ckpt_every must be >= 1"),
       (["--batch", "0"], "--batch must be >= 1"),
       (["--crop", "25"], "--crop must be a positive multiple"),
       (["--crop", "27", "--trunk", "packed"], "needs an even LR crop")]


@pytest.mark.parametrize("flags,msg", BAD, ids=[b[1][:20] for b in BAD])
def test_cli_bad_flags_match_jax(folder, tmp_path, capsys, flags, msg):
    argv = ["train", "--platform", "cpu", str(tmp_path / "o.rsr"), folder,
            *flags]
    assert cli.main(argv) == 2
    ours = capsys.readouterr().err
    assert msg in ours
    assert j_cli.main(argv) == 2
    assert capsys.readouterr().err == ours


# Every flag value of the JAX CLI's train runs; what exits 2 is a mesh
# the crop or the processes cannot hold.
@pytest.mark.parametrize("flags,msg", [
    (["--mesh", "data=2,spatial=9", "--crop", "24"], "more shards"),
    (["--precision", "high", "--trunk", "packed", "--crop", "24", "--mesh",
      "data=1,spatial=5"], "LR row pairs"),
    (["--coordinator", "h:1", "--num_processes", "2", "--process_id", "0",
      "--mesh", "data=2,spatial=2"], "must equal --num_processes")],
    ids=["mesh", "precision-high", "multi-host"])
def test_cli_unported_train_flags_exit_2(folder, capsys, flags, msg):
    assert cli.main(["train", *flags, "w.rsr", folder]) == 2
    assert msg in capsys.readouterr().err


def test_cli_start_errors(folder, tmp_path, capsys):
    base = ["train", "--platform", "cpu", str(tmp_path / "o.rsr"), folder]
    assert cli.main(base + ["-s", str(tmp_path / "none.rsr")]) == 1
    assert "Error opening start parameter file" in capsys.readouterr().err
    P.save_rsr_file(str(tmp_path / "f2.rsr"), P.init_params(0, 2), 2)
    assert cli.main(base + ["-s", str(tmp_path / "f2.rsr")]) == 1
    assert "same factor" in capsys.readouterr().err
    empty = tmp_path / "empty"
    empty.mkdir()
    assert cli.main(["train", "--platform", "cpu", "o.rsr", str(empty)]) == 1
    assert "no images" in capsys.readouterr().err


def test_cli_train_gpu_platform_raises_without_cuda(folder, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--platform cpu"):
        cli.main(["train", str(tmp_path / "o.rsr"), folder])


def test_api_train_folder(folder, tmp_path):
    mf = str(tmp_path / "m.jsonl")
    tree = api.train_folder(folder, steps=2, crop=24, batch_size=2,
                            start=small(), val_folder=folder, val_max=1,
                            metrics_file=mf, amp=True, checkpoint_every=2,
                            val_every=2, device="cpu")
    assert set(tree) == set(small()) and tree["conv0"].shape == (5, 5, 3, 8)
    assert all(np.isfinite(v).all() for v in tree.values())
    recs = [json.loads(ln) for ln in open(mf)]
    assert [r["step"] for r in recs] == [1, 2]
    assert all("val_psnr" in r for r in recs)
    with pytest.raises(ValueError, match="precision"):
        api.train_folder(folder, steps=1, precision="low", device="cpu")
    with pytest.raises(ValueError, match="do not make a mesh"):
        api.train_folder(folder, steps=1, n_spatial=2, device="cpu")
    with pytest.raises(ValueError, match="val_every"):
        api.train_folder(folder, steps=1, val_every=0, device="cpu")
    with pytest.raises(ValueError, match="even LR crop"):
        api.train_folder(folder, steps=1, crop=27, trunk="packed",
                         device="cpu")
