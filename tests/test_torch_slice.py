"""The port's single-image paths against the JAX package's.

The fused engine's paths (the xla engine's are in tests/test_torch_xla.py):

- Exact tier: port `tiled_sr(engine="fused")` on the CPU (the trunk's
  plain version) against JAX `tiled_sr(engine="fused",
  compute_dtype=f32)` (its Pallas trunk in interpret mode) and against
  JAX whole-image `sr_apply`, at f32 atol 3e-6 — the JAX suite's
  exact-tier bound (tests/test_pallas_trunk.py, tests/test_tiling.py).
  The CLIs are held to at most 1 u8 code: outputs within 3e-6 can still
  round to neighbouring codes.
- Fast tier (bf16 trunk): within 4 u8 codes of JAX's fused fast tier —
  the JAX suite's bound for the same bf16 products summed in another
  order (tests/test_tiling.py, test_fast_tier_s2d_close_to_exact) — and
  in the bf16 class against the exact tier: at least 45 dB and at most 8
  codes (the same test).
- Bilinear and downsample modes: at most 1 u8 code with under 1e-3 of
  the values differing, the JAX suite's bound for its tiled modes
  against the whole image (test_tiled_simple_*_matches_whole); f32
  outputs at atol 1e-6 (pow may differ by an ulp between XLA and torch).

Small tiles and chunks throughout: the JAX side interprets its Pallas
kernel.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rusty_sr_tpu import api as j_api
from rusty_sr_tpu import cli as j_cli
from rusty_sr_tpu.models.sr_net import sr_apply as j_sr_apply
from rusty_sr_tpu.params import load_builtin
from rusty_sr_tpu.parallel.tiling import (tiled_simple as j_tiled_simple,
                                          tiled_sr as j_tiled_sr)
from rusty_sr_tpu_torch import api, cli
from rusty_sr_tpu_torch.models.sr_net import sr_apply
from rusty_sr_tpu_torch.parallel.tiling import tiled_simple, tiled_sr
from rusty_sr_tpu_torch.params import to_torch
from rusty_sr_tpu_torch.utils.imageio import (load_image_u8, psnr,
                                              save_image_u8, to_u8)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 3e-6


@pytest.fixture(scope="module")
def anime():
    return load_builtin("anime")


def image(shape, seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def u8_image(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


def codes(a, b):
    """Max u8 difference and the share of values that differ."""
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return int(d.max()), float((d > 0).mean())


def jax_whole(params, img):
    p = {k: jnp.asarray(v) for k, v in params.items()}
    return np.asarray(jax.jit(lambda q, x: j_sr_apply(q, x, 3))(
        p, jnp.asarray(img)[None])[0])


@pytest.mark.parametrize("shape", [(40, 56, 3), (37, 21, 3), (1, 1, 3),
                                   (1, 19, 3)],
                         ids=["40x56", "ragged-37x21", "1x1", "1x19"])
def test_tiled_slice_matches_jax(anime, shape):
    img = image(shape)
    got = tiled_sr(anime, img, 3, tile=16, chunk=4, engine="fused",
                   device="cpu")
    assert got.shape == (shape[0] * 3, shape[1] * 3, 3)
    want = j_tiled_sr({k: jnp.asarray(v) for k, v in anime.items()}, img, 3,
                      tile=16, chunk=4, engine="fused",
                      compute_dtype=jnp.float32)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, jax_whole(anime, img), atol=ATOL)


@pytest.mark.parametrize("shape", [(40, 56, 3), (37, 21, 3), (1, 19, 3)],
                         ids=["40x56", "ragged-37x21", "1x19"])
def test_tiled_fast_tier_matches_jax(anime, shape):
    """The bf16 trunk, on u8-valued input as the CLI gives it: within 4
    codes of JAX's fused fast tier, in the bf16 class against exact."""
    img = u8_image(shape, 4).astype(np.float32) / 255.0
    fast = tiled_sr(anime, img, 3, tile=16, chunk=4, engine="fused",
                    device="cpu", compute_dtype=torch.bfloat16)
    want = j_tiled_sr({k: jnp.asarray(v) for k, v in anime.items()}, img, 3,
                      tile=16, chunk=4, engine="fused",
                      compute_dtype=jnp.bfloat16)
    assert fast.shape == want.shape == (shape[0] * 3, shape[1] * 3, 3)
    assert codes(to_u8(fast), to_u8(want))[0] <= 4
    exact = tiled_sr(anime, img, 3, tile=16, chunk=4, engine="fused",
                     device="cpu")
    assert psnr(to_u8(fast) / 255.0, to_u8(exact) / 255.0) >= 45.0
    assert codes(to_u8(fast), to_u8(exact))[0] <= 8


def test_whole_image_net_matches_jax(anime):
    img = image((13, 17, 3), 1)
    got = sr_apply(to_torch(anime, "cpu"), torch.from_numpy(img)[None], 3)
    np.testing.assert_allclose(got[0].numpy(), jax_whole(anime, img),
                               atol=ATOL)


def test_api_upscale(anime):
    u8 = (image((9, 14, 3), 2) * 255).astype(np.uint8)
    got = api.upscale(u8, anime, 3, engine="fused", tile=16, chunk=4,
                      device="cpu")
    want = tiled_sr(anime, u8.astype(np.float32) / 255.0, 3, tile=16,
                    chunk=4, engine="fused", device="cpu")
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="finite sRGB"):
        api.upscale(image((4, 4, 3)) * 2.0, anime, device="cpu")
    with pytest.raises(ValueError, match="engine must be"):
        tiled_sr(anime, image((4, 4, 3)), engine="int4", device="cpu")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tiled_sr(anime, image((4, 4, 3)), device="cpu",
                 compute_dtype=torch.float16)


def test_api_upscale_fast(anime):
    u8 = u8_image((9, 14, 3), 5)
    got = api.upscale(u8, anime, 3, fast=True, engine="fused", tile=16,
                      chunk=4, device="cpu")
    want = tiled_sr(anime, u8.astype(np.float32) / 255.0, 3, tile=16,
                    chunk=4, engine="fused", device="cpu",
                    compute_dtype=torch.bfloat16)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def lr_png(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("png") / "lr.png")
    save_image_u8(path, (image((26, 35, 3), 3) * 255).astype(np.uint8))
    return path


def test_cli_png_within_one_code_of_jax_cli(lr_png, tmp_path):
    args = ["--engine", "fused", "--platform", "cpu", "--tile", "16",
            "--chunk", "4", "-p", "anime", lr_png]
    assert cli.main(args + [str(tmp_path / "t.png")]) == 0
    assert j_cli.main(args + [str(tmp_path / "j.png")]) == 0
    t = load_image_u8(str(tmp_path / "t.png")).astype(int)
    j = load_image_u8(str(tmp_path / "j.png")).astype(int)
    assert t.shape == j.shape == (78, 105, 3)
    assert np.abs(t - j).max() <= 1


def test_cli_fast_within_four_codes_of_jax_cli(lr_png, tmp_path):
    args = ["--engine", "fused", "--platform", "cpu", "--fast", "--tile",
            "16", "--chunk", "4", "-p", "anime", lr_png]
    assert cli.main(args + [str(tmp_path / "t.png")]) == 0
    assert j_cli.main(args + [str(tmp_path / "j.png")]) == 0
    t = load_image_u8(str(tmp_path / "t.png"))
    j = load_image_u8(str(tmp_path / "j.png"))
    assert t.shape == j.shape == (78, 105, 3)
    assert codes(t, j)[0] <= 4


SIMPLE = [("bilinear", (40, 56, 3)), ("bilinear", (37, 23, 3)),
          ("bilinear", (1, 19, 3)), ("downsample", (40, 56, 3)),
          ("downsample", (37, 23, 3)), ("downsample", (3, 20, 3))]


@pytest.mark.parametrize("mode,shape", SIMPLE,
                         ids=[f"{m}-{s[0]}x{s[1]}" for m, s in SIMPLE])
def test_tiled_simple_matches_jax(mode, shape):
    """u8 in, u8 out through several tiles and a padded last chunk."""
    img = u8_image(shape, 6)
    if mode == "downsample":
        img = img[: shape[0] - shape[0] % 3, : shape[1] - shape[1] % 3]
    got = tiled_simple(img, 3, mode=mode, tile=15, chunk=4, device="cpu")
    want = j_tiled_simple(img, 3, mode=mode, tile=15, chunk=4)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape
    worst, share = codes(got, want)
    assert worst <= 1 and share < 1e-3


@pytest.mark.parametrize("mode", ["bilinear", "downsample"])
def test_tiled_simple_float_matches_jax(mode):
    img = image((30, 42, 3), 7)
    got = tiled_simple(img, 3, mode=mode, tile=15, chunk=4, device="cpu")
    want = j_tiled_simple(img, 3, mode=mode, tile=15, chunk=4)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("fn", ["upscale_bilinear", "downscale"])
def test_api_simple_modes_match_jax(fn):
    img = u8_image((34, 29, 3), 8)      # ragged: downscale crops to 33x27
    got = getattr(api, fn)(img, 3, device="cpu")
    want = getattr(j_api, fn)(img, 3)
    assert got.shape == want.shape and got.dtype == np.uint8
    worst, share = codes(got, want)
    assert worst <= 1 and share < 1e-3


@pytest.mark.parametrize("flag", [["-p", "bilinear"], ["-d"]],
                         ids=["bilinear", "downsample"])
def test_cli_simple_modes_match_jax_cli(lr_png, tmp_path, capsys, flag):
    assert cli.main(["--platform", "cpu", *flag, lr_png,
                     str(tmp_path / "t.png")]) == 0
    ours = capsys.readouterr().out
    assert j_cli.main(["--platform", "cpu", *flag, lr_png,
                       str(tmp_path / "j.png")]) == 0
    assert capsys.readouterr().out == ours
    t = load_image_u8(str(tmp_path / "t.png"))
    j = load_image_u8(str(tmp_path / "j.png"))
    assert t.shape == j.shape == ((78, 105, 3) if flag[0] == "-p"
                                  else (8, 11, 3))
    worst, share = codes(t, j)
    assert worst <= 1 and share < 1e-3


def test_cli_custom_weights_equal_builtin(lr_png, tmp_path):
    base = ["--platform", "cpu", "--tile", "16", "--chunk", "4"]
    assert cli.main(base + ["-p", "anime", lr_png, str(tmp_path / "p.png")]) == 0
    custom = os.path.join(ROOT, "rusty_sr_tpu", "weights", "anime.rsr")
    assert cli.main(base + ["-c", custom, lr_png, str(tmp_path / "c.png")]) == 0
    assert (tmp_path / "p.png").read_bytes() == (tmp_path / "c.png").read_bytes()


# --mesh runs every axis on every path the JAX CLI takes it on
# (tests/test_torch_mesh_cli.py); what still exits 2, as in JAX or for
# the devices: a mesh with the fused engine or the simple modes, a
# process count other than the mesh's, a malformed spec.
@pytest.mark.parametrize("argv,msg", [
    (["--mesh", "data=2,spatial=2", "--engine", "fused", "IN", "OUT"],
     "'xla' engine"),
    (["--mesh", "data=1,model=2", "-p", "bilinear", "DIR", "OUT"],
     "bilinear/downsample"),
    (["train", "--mesh", "data=2,spatial=2", "--coordinator", "h:1",
      "--num_processes", "2", "--process_id", "0", "w.rsr", "DIR"],
     "must equal --num_processes"),
    (["watch", "--mesh", "data=1,spatial=0", "DIR", "OUT"], "bad --mesh")],
    ids=["mesh", "folder", "train", "watch"])
def test_cli_unported_paths_exit_2(argv, msg, tmp_path, capsys):
    argv = [str(tmp_path) if a == "DIR" else a for a in argv]
    assert cli.main(argv) == 2
    assert msg in capsys.readouterr().err


def test_cli_conflicts_and_bad_files(lr_png, tmp_path, capsys):
    assert cli.main(["-c", "x.rsr", "-p", "anime", lr_png, "o.png"]) == 2
    assert cli.main(["--platform", "cpu", str(tmp_path / "missing.png"),
                     str(tmp_path / "o.png")]) == 1
    assert "Error opening input image file" in capsys.readouterr().err
    assert cli.main(["--platform", "cpu", "-f", "2", "-p", "anime", lr_png,
                     str(tmp_path / "o.png")]) == 1
    assert "do not have the size" in capsys.readouterr().err


def test_cli_gpu_platform_raises_without_cuda(lr_png, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--platform cpu"):
        cli.main([lr_png, str(tmp_path / "o.png")])


def test_cli_codec_error_before_the_device(lr_png, tmp_path, monkeypatch,
                                           capsys):
    from rusty_sr_tpu_torch.utils import imageio
    monkeypatch.setattr(imageio, "_pil", lambda: None)
    ran = []
    monkeypatch.setattr("rusty_sr_tpu_torch.parallel.tiling.tiled_sr",
                        lambda *a, **k: ran.append(1))
    assert cli.main(["--platform", "cpu", lr_png,
                     str(tmp_path / "o.jpg")]) == 1
    assert "only .png" in capsys.readouterr().err and not ran


def test_port_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import rusty_sr_tpu_torch, rusty_sr_tpu_torch.cli\n"
            "import rusty_sr_tpu_torch.parallel.tiling\n"
            "import rusty_sr_tpu_torch.ops.cuda._build\n"
            "bad = [m for m, mod in sys.modules.items() if mod is not None "
            "and (m == 'rusty_sr_tpu' or m.startswith('rusty_sr_tpu.') "
            "or m.startswith('jax'))]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_package_sources_name_no_jax():
    pkg = os.path.join(ROOT, "rusty_sr_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if name.endswith((".py", ".cu")):
                with open(os.path.join(dirpath, name)) as f:
                    text = f.read()
                assert "import jax" not in text, name
                assert "rusty_sr_tpu." not in text, name
