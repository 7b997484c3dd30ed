"""The port's mesh (`rusty_sr_tpu_torch/parallel/mesh.py`, the data axis)
against its single-device path and the JAX package's mesh, on the CPU.

A CPU mesh of N is N entries of the CPU device, standing in for N cards
as the JAX suite's eight virtual CPU devices do (tests/conftest.py).
Bounds:
- sharded against single-device in the port: byte-identical.  A tile's
  result does not depend on the device that runs it, and each device's
  chunk holds the same tiles in the same places as the single-device
  chunk.  CPU convolutions are not bit-stable under parallel load, so
  these comparisons run on one thread;
- against JAX's sharded outputs: the port-vs-JAX tiling bounds, 1 u8
  code exact and 4 fast (tests/test_torch_serving.py);
- the whole-image net over a sharded batch: atol 1e-5, as
  tests/test_parallel.py::test_dp_inference_matches_single_device.
"""

import json
import os
import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from rusty_sr_tpu.parallel import mesh as jmesh
from rusty_sr_tpu.parallel import tiling as jtiling
from rusty_sr_tpu_torch import api, cli
from rusty_sr_tpu_torch.params import init_params, load_builtin
from rusty_sr_tpu_torch.parallel import tiling
from rusty_sr_tpu_torch.parallel.mesh import (make_mesh, make_sharded_apply,
                                              shard_batch, tiled_sr_sharded)
from rusty_sr_tpu_torch.train import loop as TL
from rusty_sr_tpu_torch.utils.imageio import load_image_u8, save_image_u8

SHAPES = ((40, 56), (25, 30), (64, 40))   # LR (H, W): ragged at any tile


def images(seed=0):
    r = np.random.default_rng(seed)
    return [(r.random((h, w, 3)) * 255).astype(np.uint8) for h, w in SHAPES]


def cpu_mesh(n):
    return make_mesh(n_data=n, devices=["cpu"] * n)


def codes(a, b):
    assert a.shape == b.shape
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def anime():
    return load_builtin("anime")


# tile 18: padded side 32, so --fast takes the packed tier; tile 19:
# padded side 33, the flat tier.
@pytest.mark.parametrize("tile", [18, 19])
@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_sharded_batch_byte_identical_to_single_device(anime, one_thread,
                                                       tile, fast):
    cd = torch.bfloat16 if fast else None
    imgs = images()
    single = tiling.tiled_sr_batch(anime, imgs, 3, tile=tile, chunk=2,
                                   compute_dtype=cd, device="cpu")
    done = []
    sharded = tiling.tiled_sr_batch(
        anime, imgs, 3, tile=tile, chunk=2, compute_dtype=cd,
        mesh=cpu_mesh(4), on_image_done=lambda i, out: done.append(i))
    assert done == [0, 1, 2]
    for s, g in zip(single, sharded):
        assert g.dtype == np.uint8 and g.tobytes() == s.tobytes()
    one = tiled_sr_sharded(anime, imgs[2], cpu_mesh(3), 3, tile=tile,
                           chunk=2, compute_dtype=cd)
    assert one.tobytes() == single[2].tobytes()
    api_outs = api.upscale_batch(imgs, anime, 3, fast=fast, tile=tile,
                                 chunk=2, mesh=cpu_mesh(2))
    for s, g in zip(single, api_outs):
        assert g.tobytes() == s.tobytes()


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_sharded_batch_matches_jax_mesh(anime, fast):
    imgs = images(1)
    got = tiling.tiled_sr_batch(anime, imgs, 3, tile=18, chunk=2,
                                compute_dtype=torch.bfloat16 if fast
                                else None, mesh=cpu_mesh(4))
    want = jtiling.tiled_sr_batch(
        {k: jnp.asarray(v) for k, v in anime.items()}, imgs, 3, tile=18,
        compute_dtype=jnp.bfloat16 if fast else None,
        mesh=jmesh.make_mesh(n_data=8))
    for g, w in zip(got, want):
        assert codes(g, w) <= (4 if fast else 1)


def test_sharded_apply_matches_jax():
    tree = init_params(0, 3)
    x = np.random.default_rng(3).random((8, 24, 24, 3), dtype=np.float32)
    mesh = cpu_mesh(8)
    shards = shard_batch(mesh, x)
    assert [tuple(s.shape) for s in shards] == [(1, 24, 24, 3)] * 8
    got = np.concatenate([o.numpy() for o in
                          make_sharded_apply(mesh, 3)(tree, shards)])
    jm = jmesh.make_mesh(n_data=8)
    want = np.asarray(jmesh.make_sharded_apply(jm, 3)(
        {k: jnp.asarray(v) for k, v in tree.items()},
        jmesh.shard_batch(jm, x)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    with pytest.raises(ValueError, match="evenly"):
        shard_batch(mesh, x[:6])


def test_make_mesh_contract():
    m = make_mesh(devices=["cpu", "cpu", "cpu"])
    assert m.shape == {"data": 3, "spatial": 1, "model": 1}
    assert m.devices == (torch.device("cpu"),) * 3
    assert make_mesh(2, devices=["cpu"] * 3).shape["data"] == 2
    with pytest.raises(ValueError, match="devices"):
        make_mesh(n_data=3, devices=["cpu", "cpu"])   # over-subscribed
    with pytest.raises(ValueError, match="devices"):
        make_mesh(n_data=0, devices=["cpu"])
    for kw, shape in (({"n_spatial": 2}, (1, 2, 1)),
                      ({"n_model": 2}, (1, 1, 2))):
        m = make_mesh(1, devices=["cpu"] * 4, **kw)
        assert tuple(m.shape.values()) == shape and len(m.devices) == 2
        assert m.lanes == (torch.device("cpu"),)
    m = make_mesh(n_spatial=2, n_model=2, devices=["cpu"] * 9)
    assert m.shape == {"data": 2, "spatial": 2, "model": 2}
    with pytest.raises(ValueError, match="devices"):
        make_mesh(2, n_spatial=3, devices=["cpu"] * 5)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no CUDA device"):
            make_mesh(1)


def test_parse_mesh():
    for spec in ("4", "data=4", "data=4,spatial=1,model=1"):
        m = cli._parse_mesh(spec, "cpu")
        assert m.shape["data"] == 4 and m.devices[0].type == "cpu"
    assert cli._parse_mesh_spec("data=2,model=3") == {
        "data": 2, "spatial": 1, "model": 3}
    for bad in ("x", "data=x", "spatial=2", "data=2,foo=1", "0", "data=-1"):
        with pytest.raises(ValueError):
            cli._parse_mesh(bad, "cpu")


@pytest.fixture
def folder(tmp_path):
    src = tmp_path / "in"
    src.mkdir()
    for i, img in enumerate(images(2)):
        save_image_u8(str(src / f"im{i}.png"), img)
    return src


def outputs(path):
    return {n: load_image_u8(str(path / n)) for n in sorted(os.listdir(path))}


@pytest.mark.parametrize("mode", ["folder", "watch"])
def test_cli_mesh_byte_identical(folder, tmp_path, one_thread, mode):
    """The folder mode (exact) and ``watch --once --fast --metrics`` with
    ``--mesh data=4`` against the same runs without it."""
    base = ["--platform", "cpu", "-p", "anime", "--tile", "18", "--chunk",
            "2"]
    if mode == "watch":
        base = ["watch", "--once", "--fast", "--metrics",
                str(tmp_path / "m.jsonl"), *base]
    runs = {}
    for flags in ([], ["--mesh", "data=4"]):
        dst = tmp_path / f"out{len(flags)}"
        assert cli.main([*base, *flags, str(folder), str(dst)]) == 0
        runs[len(flags)] = outputs(dst)
    assert sorted(runs[2]) == ["im0.png", "im1.png", "im2.png"]
    for n in runs[0]:
        assert runs[2][n].tobytes() == runs[0][n].tobytes(), n
    if mode == "watch":
        recs = [json.loads(ln) for ln in open(tmp_path / "m.jsonl")]
        assert [r["images"] for r in recs] == [3, 3]
        assert recs[-1]["failed"] == 0 and recs[-1]["hr_mpix"] > 0


def test_cli_single_image_mesh(tmp_path, one_thread):
    src = str(tmp_path / "a.png")
    save_image_u8(src, images(3)[0])
    base = ["--platform", "cpu", "-p", "anime", "--tile", "18", "--fast"]
    assert cli.main([*base, src, str(tmp_path / "one.png")]) == 0
    assert cli.main([*base, "--mesh", "2", src,
                     str(tmp_path / "two.png")]) == 0
    assert (tmp_path / "one.png").read_bytes() == \
        (tmp_path / "two.png").read_bytes()


@pytest.mark.parametrize("argv,msg", [
    (["--engine", "fused", "--mesh", "2", "IN", "o.png"], "'xla' engine"),
    (["-p", "bilinear", "--mesh", "2", "DIR", "OUT"], "bilinear/downsample"),
    (["-d", "--mesh", "data=2", "DIR", "OUT"], "bilinear/downsample"),
    (["--mesh", "data=2,bogus=1", "IN", "o.png"], "bad --mesh"),
    (["watch", "--mesh", "two", "DIR", "OUT"], "bad --mesh"),
    (["train", "--mesh", "data=", "w.rsr", "DIR"], "bad --mesh")],
    ids=["fused", "bilinear-folder", "downsample", "bad-axis", "watch-bad",
         "train-bad"])
def test_cli_mesh_refusals_exit_2(folder, tmp_path, capsys, argv, msg):
    img = str(folder / "im0.png")
    argv = [str(folder) if a == "DIR" else img if a == "IN" else
            str(tmp_path / a) if a in ("o.png", "OUT") else a for a in argv]
    assert cli.main(["--platform", "cpu", *argv] if argv[0] not in
                    ("watch", "train") else argv) == 2
    assert msg in capsys.readouterr().err


def test_cli_mesh_gpu_platform_without_cuda_raises(folder, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--platform cpu"):
        cli.main(["--mesh", "2", "-p", "anime", str(folder),
                  str(tmp_path / "o")])


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_dp_step_of_one_rank_is_the_plain_step():
    """A data-parallel step over a group of one (gloo) takes the flat
    buffer's all-reduce and division by 1: bit for bit the plain step."""
    tree = init_params(1, 3, width=8)
    hr = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (2, 24, 24, 3), dtype=np.uint8))
    cfg = TL.TrainConfig(crop=24, batch_size=2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        runs = []
        for group in (None, dist.group.WORLD):
            p = {k: torch.tensor(v, requires_grad=True)
                 for k, v in tree.items()}
            step, _ = TL.make_train_step(cfg, p, group)
            losses = [step(hr) for _ in range(2)]
            runs.append(([(float(a), float(b)) for a, b in losses],
                         {k: v.detach().numpy() for k, v in p.items()}))
    finally:
        dist.destroy_process_group()
    assert runs[0][0] == runs[1][0]
    for k in tree:
        assert runs[0][1][k].tobytes() == runs[1][1][k].tobytes(), k


# --- every output byte is written: the outputs come from np.empty -------

class _FilledEmpty:
    """numpy, but for `empty`, which fills with ``fill``."""

    def __init__(self, fill):
        self.fill, self.shapes = fill, []

    def __getattr__(self, name):
        return getattr(np, name)

    def empty(self, shape, dtype=float):
        self.shapes.append(tuple(shape))
        return np.full(shape, self.fill, dtype)


def _f32(img):
    return img.astype(np.float32) / 255.0


def _mult3(img):
    return img[:img.shape[0] - img.shape[0] % 3,
               :img.shape[1] - img.shape[1] % 3]


# chunk 5 over SHAPES' 12 + 4 + 12 tiles at tile 18: chunks span images
_KW = dict(tile=18, chunk=5, device="cpu")
COVER = {
    "tiled_sr-u8": lambda p: [tiling.tiled_sr(p, images()[0], 3, **_KW)],
    "tiled_sr-f32": lambda p: [tiling.tiled_sr(p, _f32(images()[2]), 3,
                                               **_KW)],
    "tiled_sr-u8-fast": lambda p: [tiling.tiled_sr(
        p, images()[1], 3, compute_dtype=torch.bfloat16, **_KW)],
    "batch-u8": lambda p: tiling.tiled_sr_batch(p, images(), 3, **_KW),
    "batch-f32": lambda p: tiling.tiled_sr_batch(
        p, [_f32(im) for im in images()], 3, **_KW),
    "batch-u8-mesh": lambda p: tiling.tiled_sr_batch(
        p, images(), 3, mesh=cpu_mesh(2), tile=18, chunk=5),
    "simple-bilinear": lambda p: [tiling.tiled_simple(
        images()[0], 3, mode="bilinear", **_KW)],
    "simple-downsample": lambda p: [tiling.tiled_simple(
        _mult3(images()[2]), 3, mode="downsample", **_KW)],
}


@pytest.mark.parametrize("case", list(COVER))
def test_tile_grid_writes_every_output_byte(anime, monkeypatch, one_thread,
                                            case):
    """The outputs come from `np.empty`: filled with 0 and then with 255
    in its place, every mode gives the same bytes, so the tile scatter
    writes each of them."""
    got = []
    for fill in (0, 255):
        filled = _FilledEmpty(fill)
        monkeypatch.setattr(tiling, "np", filled)
        outs = COVER[case](anime)
        assert all(o.shape in filled.shapes for o in outs)
        got.append([(o.dtype, o.shape, o.tobytes()) for o in outs])
    assert got[0] == got[1]
