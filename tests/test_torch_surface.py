"""The port's public surface against the JAX package's, on the CPU: the
names each `__init__` exports, the f32 `utils.imageio.load_image`,
`utils.profiling.device_timer` (and its `_perturb`), and the CLI's
``--mesh`` on a single bilinear or downsample image, which the JAX CLI
runs on one device."""

import importlib
import inspect
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rusty_sr_tpu import cli as j_cli
from rusty_sr_tpu.utils import imageio as j_imageio
from rusty_sr_tpu.utils import profiling as j_profiling
from rusty_sr_tpu_torch import cli
from rusty_sr_tpu_torch.utils import imageio, profiling
from test_torch_xla import u8_image

PACKAGES = ["", ".models", ".ops", ".parallel", ".utils", ".train"]


def public_names(mod):
    return sorted(n for n, v in vars(mod).items()
                  if not n.startswith("_") and not inspect.ismodule(v))


@pytest.mark.parametrize("sub", PACKAGES,
                         ids=[p.lstrip(".") or "top" for p in PACKAGES])
def test_every_jax_export_is_in_the_port_at_the_same_place(sub):
    jmod = importlib.import_module("rusty_sr_tpu" + sub)
    mod = importlib.import_module("rusty_sr_tpu_torch" + sub)
    names = public_names(jmod)
    assert names
    for name in names:
        assert hasattr(mod, name), f"rusty_sr_tpu_torch{sub}.{name}"
        j_home = getattr(getattr(jmod, name), "__module__", None)
        home = getattr(getattr(mod, name), "__module__", None)
        if j_home is not None and j_home.startswith("rusty_sr_tpu."):
            assert home == "rusty_sr_tpu_torch" + j_home[len("rusty_sr_tpu"):]


def test_importing_the_packages_builds_no_kernel():
    code = ("import sys\n"
            "import rusty_sr_tpu_torch, rusty_sr_tpu_torch.ops, "
            "rusty_sr_tpu_torch.models, rusty_sr_tpu_torch.parallel, "
            "rusty_sr_tpu_torch.utils, rusty_sr_tpu_torch.train\n"
            "bad = [m for m in sys.modules if m.endswith('._build') "
            "or m in ('jax', 'rusty_sr_tpu', 'triton')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_load_image_equals_jax(tmp_path):
    from PIL import Image
    rgba = np.concatenate([u8_image((19, 23, 3), 41),
                           np.random.default_rng(41).integers(
                               0, 256, (19, 23, 1), dtype=np.uint8)], -1)
    path = str(tmp_path / "a.png")
    Image.fromarray(rgba, "RGBA").save(path)
    got = imageio.load_image(path)
    want = j_imageio.load_image(path)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (19, 23, 3)
    assert got.tobytes() == want.tobytes()
    assert got.tobytes() == (rgba[..., :3].astype(np.float32)
                             / 255.0).tobytes()


def test_perturb_equals_jax():
    rng = np.random.default_rng(42)
    tree = {"u8": rng.integers(250, 256, (3, 4), dtype=np.uint8),
            "pair": (rng.random((2, 3), dtype=np.float32),
                     rng.integers(-5, 5, (4,), dtype=np.int32)),
            "list": [np.array([True, False]), np.full(2, 0.5, np.float32)],
            "name": "x"}
    for r in (1, 3):
        want = j_profiling._perturb(
            {"u8": jnp.asarray(tree["u8"]),
             "pair": tuple(jnp.asarray(t) for t in tree["pair"]),
             "list": [jnp.asarray(t) for t in tree["list"]],
             "name": "x"}, r)
        got = profiling._perturb(
            {"u8": torch.from_numpy(tree["u8"]),
             "pair": tuple(torch.from_numpy(t) for t in tree["pair"]),
             "list": [torch.from_numpy(t) for t in tree["list"]],
             "name": "x"}, r)
        assert got["name"] == want["name"] == "x"
        pairs = [(got["u8"], want["u8"])] + list(zip(got["pair"],
                                                     want["pair"])) \
            + list(zip(got["list"], want["list"]))
        for g, w in pairs:
            assert g.numpy().tobytes() == np.asarray(w).tobytes()
        assert got["u8"].dtype == torch.uint8          # wrapped, not widened
    bf = profiling._perturb(torch.ones(3, dtype=torch.bfloat16), 2)
    assert bf.dtype == torch.bfloat16 and bool((bf == 3).all())


def test_device_timer_calls_and_carries():
    """(1 warm-up + rounds) chains of ``iters`` calls; ``fold`` gives each
    call its input, and each round starts from the input plus its round
    number."""
    seen = []

    def fn(c):
        seen.append(float(c[0]))
        return c + 1.0

    x = torch.zeros(4)
    t = profiling.device_timer(fn, x, iters=5, rounds=2)
    assert t > 0 and len(seen) == (1 + 2) * 5
    assert seen == [0, 1, 2, 3, 4, 1, 2, 3, 4, 5, 2, 3, 4, 5, 6]
    seen.clear()
    profiling.device_timer(fn, x, iters=3, rounds=1, fold=lambda y, x0: x0)
    assert seen == [0, 0, 0, 1, 1, 1]
    seen.clear()
    profiling.device_timer(lambda d: {"v": fn(d["v"]), "k": d["k"]},
                           {"v": x, "k": "kept"}, iters=2, rounds=1)
    assert seen == [0, 1, 1, 2]


@pytest.mark.parametrize("flag", [["-p", "bilinear"], ["-d"]],
                         ids=["bilinear", "downsample"])
def test_cli_mesh_on_a_single_simple_image_runs(tmp_path, capsys, flag):
    """The JAX CLI takes a single image's bilinear or downsample path
    before it reads ``--mesh``; so does the port, with one stderr line
    saying the mesh is not used: the bytes of the run without it, and of
    the JAX CLI's."""
    src = str(tmp_path / "in.png")
    imageio.save_image_u8(src, u8_image((37, 52, 3), 43))
    base = ["--platform", "cpu", *flag, src]
    assert cli.main([*base[:2], "--mesh", "data=1", *base[2:],
                     str(tmp_path / "m.png")]) == 0
    err = capsys.readouterr().err
    assert [ln for ln in err.splitlines() if "--mesh" in ln] == [
        "note: --mesh data=1 is not used: a single bilinear or downsample "
        "image runs on one device"]
    assert cli.main([*base, str(tmp_path / "n.png")]) == 0
    assert j_cli.main([*base, str(tmp_path / "j.png")]) == 0
    m, n, j = ((tmp_path / f"{p}.png").read_bytes() for p in "mnj")
    assert m == n == j
