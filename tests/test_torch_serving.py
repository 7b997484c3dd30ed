"""The port's serving path against the JAX package's, on the CPU: folder
mode, `upscale_batch` (`tiled_sr_batch`) and ``watch``.

Bounds, from the JAX suite: at most 1 u8 code in the exact tier (outputs
within f32 noise can round to neighbouring codes) and 4 codes in the fast
tiers (the same bf16 products summed in another order,
tests/test_tiling.py).  CPU convolutions are not bit-stable under
parallel load, so two runs of the port are compared by the same bounds,
never bit for bit.  Images are made from a seed; the anime weights run
at tile 16 (packed fast tier) or 15 (flat) and chunks of 4, so chunks
span images.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from rusty_sr_tpu import api as j_api
from rusty_sr_tpu import cli as j_cli
from rusty_sr_tpu.params import load_builtin
from rusty_sr_tpu_torch import api, cli
from rusty_sr_tpu_torch.parallel import tiling
from rusty_sr_tpu_torch.parallel.mesh import make_mesh
from rusty_sr_tpu_torch.utils.imageio import load_image_u8, save_image_u8

# LR shapes: 2, 2, 4 and 6 tiles of 16, 14 in all, so chunks of 4 span
# images; each a name the namer keeps.
SHAPES = {"im0": (20, 15), "im1": (9, 31), "im2": (17, 17), "im3": (33, 21)}
TIERS = {"exact": ([], 1), "fast": (["--fast"], 4),
         "flat": (["--fast", "--tile", "15"], 4)}


def u8_image(shape, seed):
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float32)
    base = np.stack([xx / shape[1], yy / shape[0],
                     0.5 + 0.5 * np.sin(xx / 5.0 + yy / 7.0)], axis=-1)
    base = base + r.normal(0.0, 0.08, base.shape)
    return (np.clip(base, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def codes(a, b):
    assert a.shape == b.shape
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    src = tmp_path_factory.mktemp("serving") / "in"
    src.mkdir()
    for k, (name, shape) in enumerate(SHAPES.items()):
        save_image_u8(str(src / f"{name}.png"), u8_image(shape, k))
    return src


def base_args(tier, *rest):
    flags, _ = TIERS[tier]
    return ["--platform", "cpu", "-p", "anime", "--tile", "16", "--chunk",
            "4", *flags, *rest]


@pytest.fixture(scope="module")
def jax_outputs(folder, tmp_path_factory):
    """JAX folder mode's outputs per tier: name -> u8 image."""
    outs = {}
    for tier in TIERS:
        dst = tmp_path_factory.mktemp(f"jax_{tier}")
        assert j_cli.main(base_args(tier, str(folder), str(dst))) == 0
        outs[tier] = {n: load_image_u8(str(dst / f"{n}.png"))
                      for n in SHAPES}
    return outs


def read_folder(path):
    return {n: load_image_u8(os.path.join(path, f"{n}.png")) for n in SHAPES}


def assert_within(got, want, bound):
    for n in SHAPES:
        assert codes(got[n], want[n]) <= bound, n


@pytest.mark.parametrize("tier", list(TIERS))
def test_folder_mode_matches_jax(folder, jax_outputs, tmp_path, tier):
    dst = tmp_path / "out"
    assert cli.main(base_args(tier, str(folder), str(dst))) == 0
    assert sorted(os.listdir(dst)) == sorted(f"{n}.png" for n in SHAPES)
    got = read_folder(dst)
    for n, (h, w) in SHAPES.items():
        assert got[n].shape == (3 * h, 3 * w, 3)
    assert_within(got, jax_outputs[tier], TIERS[tier][1])


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_upscale_batch_matches_jax(folder, fast):
    imgs = [load_image_u8(str(folder / f"{n}.png")) for n in SHAPES]
    anime = load_builtin("anime")
    done = []
    got = api.upscale_batch(imgs, anime, 3, fast=fast, tile=16, chunk=4,
                            device="cpu",
                            on_image_done=lambda i, out: done.append(
                                (i, out.copy())),
                            release_outputs=True)
    assert got == [None] * len(imgs)
    assert [i for i, _ in done] == list(range(len(imgs)))
    want = j_api.upscale_batch(imgs, anime, 3, fast=fast, tile=16, chunk=4)
    for (_, out), w in zip(done, want):
        assert out.dtype == np.uint8
        assert codes(out, w) <= (4 if fast else 1)
    kept = api.upscale_batch(imgs, anime, 3, fast=fast, tile=16, chunk=4,
                             device="cpu")
    for (_, out), k in zip(done, kept):
        assert codes(out, k) <= (4 if fast else 1)


def test_tiled_sr_batch_contract(folder):
    anime = load_builtin("anime")
    u8 = load_image_u8(str(folder / "im0.png"))
    assert tiling.tiled_sr_batch(anime, [], device="cpu") == []
    with pytest.raises(ValueError, match="share the input dtype"):
        tiling.tiled_sr_batch(anime, [u8, u8 / 255.0], tile=16,
                              device="cpu")
    # a mesh of two CPU entries runs the tiles in place of ``device``
    mesh = make_mesh(2, devices=["cpu", "cpu"])
    one = tiling.tiled_sr_batch(anime, [u8], tile=16, chunk=4, device="cpu")
    two = tiling.tiled_sr_batch(anime, [u8], tile=16, chunk=4, mesh=mesh)
    assert two[0].dtype == np.uint8 and codes(two[0], one[0]) <= 1
    # float input takes the flat tier with f32 tiles and gives float out,
    # as tiled_sr does for one image
    f = u8.astype(np.float32) / 255.0
    got = tiling.tiled_sr_batch(anime, [f, f[:7]], 3, tile=16, chunk=4,
                                device="cpu")
    want = tiling.tiled_sr(anime, f, 3, tile=16, chunk=4, device="cpu")
    assert got[0].dtype == np.float32 and got[1].shape == (21, 45, 3)
    np.testing.assert_allclose(got[0], want, atol=3e-6)


def test_group_split_matches(folder, tmp_path, monkeypatch):
    one = tmp_path / "one"
    assert cli.main(base_args("exact", str(folder), str(one))) == 0
    monkeypatch.setattr(cli, "_GROUP_LR_BYTES", 1)   # one image a group
    many = tmp_path / "many"
    assert cli.main(base_args("exact", str(folder), str(many))) == 0
    assert_within(read_folder(many), read_folder(one), 1)


def test_watch_once_with_metrics(folder, jax_outputs, tmp_path):
    dst, metrics = tmp_path / "out", tmp_path / "m.jsonl"
    assert cli.main(["watch", *base_args("exact", "--once", "--metrics",
                                         str(metrics), str(folder),
                                         str(dst))]) == 0
    assert_within(read_folder(dst), jax_outputs["exact"], 1)
    recs = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert len(recs) == 1
    assert recs[0]["images"] == len(SHAPES) and recs[0]["failed"] == 0
    hr = sum(h * w for h, w in SHAPES.values()) * 9 / 1e6
    assert recs[0]["hr_mpix"] == round(hr, 3)
    assert set(recs[0]) == {"images", "failed", "hr_mpix", "latency_s",
                            "mpix_per_s", "wall"}


def test_watch_metrics_one_record_per_group(folder, tmp_path, monkeypatch):
    monkeypatch.setattr(cli, "_GROUP_LR_BYTES", 1)
    metrics = tmp_path / "m.jsonl"
    assert cli.main(["watch", *base_args("fast", "--once", "--metrics",
                                         str(metrics), str(folder),
                                         str(tmp_path / "o"))]) == 0
    recs = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["images"] for r in recs] == [1] * len(SHAPES)


def test_bilinear_folder_equals_single_images(folder, tmp_path):
    dst = tmp_path / "out"
    assert cli.main(["--platform", "cpu", "-p", "bilinear", str(folder),
                     str(dst)]) == 0
    for n in SHAPES:
        one = tmp_path / f"{n}.png"
        assert cli.main(["--platform", "cpu", "-p", "bilinear",
                         str(folder / f"{n}.png"), str(one)]) == 0
        np.testing.assert_array_equal(load_image_u8(str(dst / f"{n}.png")),
                                      load_image_u8(str(one)))


@pytest.mark.parametrize("paths", [
    ["/in/a.png", "/in/a.jpg", "/in/a.png", "/in/a.jpg", "/in/b.jpg"],
    ["/in/a.png", "/in/a.jpg.png", "/in/a.jpg", "/in/a.jpg", "/in/a.png",
     "/in/a.jpg.png"]], ids=["cross-batch", "fallback-chain"])
def test_stable_namer_matches_jax(paths):
    ours, theirs = cli._StableNamer(), j_cli._StableNamer()
    got = [ours(p) for p in paths]
    assert got == [theirs(p) for p in paths]
    assert len(set(got)) == len(set(paths))
    assert cli._output_names(paths[:3]) == j_cli._output_names(paths[:3])


def test_watch_scan_bookkeeping_stays_bounded(tmp_path):
    """Files churn through the folder: ``done`` and ``fails`` hold only
    what the folder holds now (tests/test_cli.py's case)."""
    done, fails = {}, {}
    for wave in range(6):
        for f in list(tmp_path.glob("*.png")):
            f.unlink()
        for i in range(3):
            save_image_u8(str(tmp_path / f"w{wave}_{i}.png"),
                          u8_image((4, 4), wave * 3 + i))
        (tmp_path / f"w{wave}_junk.png").write_bytes(b"nope")
        pending = cli._watch_scan(str(tmp_path), done, fails)
        assert len(pending) == 4
        for f, mt in pending:
            if "junk" in f:
                fails[f] = (mt, 1)
            else:
                done[f] = mt
        assert len(done) <= 3 and len(fails) <= 1, (done, fails)
    junk = str(tmp_path / "w5_junk.png")
    assert cli._watch_scan(str(tmp_path), done, fails) == [
        (junk, os.path.getmtime(junk))]
    # three failed attempts: skipped until the mtime changes
    fails[junk] = (os.path.getmtime(junk), 3)
    assert cli._watch_scan(str(tmp_path), done, fails) == []
    os.utime(junk, (time.time(), os.path.getmtime(junk) + 5))
    assert cli._watch_scan(str(tmp_path), done, fails) == [
        (junk, os.path.getmtime(junk))]


def test_watch_retries_after_mtime_change(tmp_path, monkeypatch, capsys):
    """A file that fails to decode three polls running is skipped, and
    retried once its mtime changes (a copy that ended)."""
    src, dst = tmp_path / "in", tmp_path / "out"
    src.mkdir()
    target = src / "a.png"
    target.write_bytes(b"not a png yet")
    polls = []

    def sleep(_):
        polls.append(1)
        if len(polls) == 4:      # skipped since poll 3: finish the copy
            assert not (dst / "a.png").exists()
            save_image_u8(str(target), u8_image((12, 10), 1))
            os.utime(target, (time.time(), time.time() + 10))
        elif len(polls) == 5:
            raise KeyboardInterrupt

    monkeypatch.setattr(time, "sleep", sleep)
    assert cli.main(["watch", "--platform", "cpu", "-p", "anime", "--tile",
                     "16", "--poll", "0", str(src), str(dst)]) == 0
    err = capsys.readouterr().err
    assert err.count("skipping") == 1
    assert (dst / "a.png").is_file()


def test_folder_write_failure_reports_and_continues(folder, tmp_path,
                                                    capsys):
    dst = tmp_path / "out"
    dst.mkdir()
    (dst / "im1.png").mkdir()            # the write of im1 fails
    assert cli.main(base_args("fast", str(folder), str(dst))) == 1
    err = capsys.readouterr().err
    assert "Could not write output file" in err and "im1.png" in err
    for n in ("im0", "im2", "im3"):
        assert (dst / f"{n}.png").is_file()


def _bomb() -> bytes:
    """A 66-byte PNG whose header claims 65536 x 65536 pixels."""
    import struct
    import zlib

    def chunk(t, d):
        return struct.pack(">I", len(d)) + t + d + struct.pack(
            ">I", zlib.crc32(t + d))
    ihdr = struct.pack(">II5B", 1 << 16, 1 << 16, 8, 6, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"\x00")) + chunk(b"IEND", b""))


def test_folder_unreadable_only_and_bomb(tmp_path, capsys):
    src = tmp_path / "in"
    src.mkdir()
    (src / "junk.png").write_bytes(b"not a png")
    (src / "bomb.png").write_bytes(_bomb())
    assert cli.main(["--platform", "cpu", "-p", "anime", str(src),
                     str(tmp_path / "o")]) == 1
    err = capsys.readouterr().err
    assert "no readable images" in err and "skipping" in err
    save_image_u8(str(src / "good.png"), u8_image((12, 10), 2))
    for argv in (["--platform", "cpu", "-p", "anime", "--tile", "16",
                  str(src), str(tmp_path / "o2")],
                 ["watch", "--platform", "cpu", "-p", "anime", "--tile",
                  "16", "--once", str(src), str(tmp_path / "o3")]):
        assert cli.main(argv) == 0
        err = capsys.readouterr().err
        if argv[0] != "watch":   # the watcher reports after 3 attempts
            assert "bomb.png" in err and "junk.png" in err
        out = tmp_path / argv[-1]
        assert sorted(os.listdir(out)) == ["good.png"]


# Every --mesh spec runs (tests/test_torch_mesh_cli.py); what still
# exits 2: a mesh with the fused engine, a malformed spec, a batch the
# data axis cannot split, a fused folder.
@pytest.mark.parametrize("argv,msg", [
    (["--mesh", "data=1,spatial=2", "--engine", "fused", "-p", "anime",
      "DIR", "OUT"], "'xla' engine"),
    (["watch", "--mesh", "data=1,model=0", "DIR", "OUT"], "bad --mesh"),
    (["train", "--mesh", "data=2,model=2", "--batch", "3", "w.rsr", "DIR"],
     "does not divide"),
    (["--platform", "cpu", "--engine", "fused", "-p", "anime", "DIR", "OUT"],
     "--engine xla only")],
    ids=["folder-mesh", "watch-mesh", "train", "folder-fused"])
def test_refused_paths_exit_2(argv, msg, tmp_path, capsys):
    save_image_u8(str(tmp_path / "a.png"), u8_image((5, 5), 0))
    argv = [str(tmp_path) if a == "DIR" else
            str(tmp_path / "o") if a == "OUT" else a for a in argv]
    assert cli.main(argv) == 2
    assert msg in capsys.readouterr().err


def test_trace_writes_a_chrome_trace(tmp_path):
    src = tmp_path / "a.png"
    save_image_u8(str(src), u8_image((9, 7), 3))
    assert cli.main(["--platform", "cpu", "-p", "bilinear", "--trace",
                     str(tmp_path / "tr"), str(src),
                     str(tmp_path / "o.png")]) == 0
    with open(tmp_path / "tr" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_cuda_platform_without_cuda_raises(folder, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for argv in ([str(folder), str(tmp_path / "o")],
                 ["watch", "--once", str(folder), str(tmp_path / "o")]):
        with pytest.raises(RuntimeError, match="--platform cpu"):
            cli.main(argv)
