"""SwinIR (`models/swinir.py`) against the plain reference
(`tests/swinir_reference.py`) on seeded weights at a small size: embed
width 24, 2 residual groups of 2 blocks, 3 heads, window 8, on the CPU;
through `api.upscale_batch`, the official key layout and the CLI.  The
tests marked ``cuda`` hold the window-attention kernel to its plain
version at the benchmark cell's window counts, on the card:

    python -m pytest --noconftest tests/test_torch_swinir.py -q -m cuda

Tolerances, as the largest and the mean absolute gap of the float
output (values in [0, 1]):
- exact tier: 1e-5 of the reference's largest value: the same float32
  arithmetic, summed in other orders (token-major linear layers against
  per-window ones);
- fast tier: 1.5e-2 largest and 1.5e-3 mean: bf16 GEMM and convolution
  operands (8 significant bits, a relative rounding of up to 2^-9 on
  each) through 4 blocks and 4 convolutions; measured 4.2e-3 and 6.5e-4
  on these weights, while the lightest planted fault (no shift mask)
  reads 0.059 and 3.2e-3.
"""

import filecmp
import gc
import os
import subprocess
import sys
import weakref

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import swinir_reference as ref  # noqa: E402

from rusty_sr_tpu_torch import api, params  # noqa: E402
from rusty_sr_tpu_torch.models import (load_pth, swinir,  # noqa: E402
                                       whole_frame_model)
from rusty_sr_tpu_torch.ops.cuda import window_attn as wa  # noqa: E402
from rusty_sr_tpu_torch.parallel import tiling  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(embed_dim=24, in_chans=3, depths=[2, 2], num_heads=[3, 3],
           window_size=8, mlp_ratio=2, num_feat=16, upscale=4, out_chans=3,
           img_size=64, img_range=1.0, mean=[0.4488, 0.4371, 0.4040])
EXACT_REL = 1e-5
FAST_MAX, FAST_MEAN = 1.5e-2, 1.5e-3


@pytest.fixture(scope="module")
def tree():
    return ref.draw_weights(2 ** 31 + 11, CFG)


def _frames(seed, n, h, w):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3),
                                                dtype=np.uint8)


def _reference(p, frames, fault=None):
    x = torch.from_numpy(frames).permute(0, 3, 1, 2).float() / 255.0
    with ref.exact(), torch.no_grad():
        return ref.forward(p, x, CFG, fault=fault).permute(0, 2, 3, 1)


def _model(p, frames, fast):
    return swinir.forward(swinir.prepare(p, "cpu", fast),
                          torch.from_numpy(frames), to_u8=False)


def _within(out, want, fast) -> bool:
    d = (out - want).abs()
    if fast:
        return float(d.max()) <= FAST_MAX and float(d.mean()) <= FAST_MEAN
    return float(d.max()) <= EXACT_REL * float(want.abs().max())


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("size", [(24, 32), (37, 45)])
def test_model_matches_the_reference(tree, fast, size):
    """Both tiers; 37x45 is a multiple of 8 on neither side, so the frame
    is reflect-padded and the output cropped."""
    frames = _frames(3, 2, *size)
    out = _model(tree, frames, fast)
    want = _reference(tree, frames)
    assert out.shape == (2, 4 * size[0], 4 * size[1], 3)
    assert _within(out, want, fast)


@pytest.mark.parametrize("fault", ref.FAULTS)
def test_planted_faults_fail_the_comparison(tree, fault):
    frames = _frames(4, 2, 24, 32)
    bad = _reference(tree, frames, fault)
    for fast in (False, True):
        assert not _within(_model(tree, frames, fast), bad, fast), fault


def test_upscale_batch_two_sizes_equals_single_calls(tree):
    """Frames of two sizes interleaved: one chunk group a size, the
    outputs and the ``on_image_done`` order those of one call a frame."""
    a, b = _frames(5, 3, 24, 32), _frames(6, 2, 37, 45)
    frames = [a[0], b[0], a[1], a[2], b[1]]
    order = []
    outs = api.upscale_batch(frames, weights=tree, fast=True, chunk=2,
                             device="cpu",
                             on_image_done=lambda i, o: order.append(i))
    assert order == [0, 1, 2, 3, 4]
    for im, out in zip(frames, outs):
        one = api.upscale(im, tree, fast=True, device="cpu")
        np.testing.assert_array_equal(one, out)
        assert out.shape == (4 * im.shape[0], 4 * im.shape[1], 3)


def test_upscale_batch_releases_in_order(tree):
    frames = [_frames(7, 1, 24, 32)[0], _frames(8, 1, 16, 24)[0],
              _frames(9, 1, 24, 32)[0]]
    got = []
    outs = api.upscale_batch(frames, weights=tree, chunk=4, device="cpu",
                             release_outputs=True,
                             on_image_done=lambda i, o: got.append(
                                 (i, o.shape)))
    assert [i for i, _ in got] == [0, 1, 2]
    assert outs == [None, None, None]
    assert got[1][1] == (64, 96, 3)


def test_upscale_batch_frees_each_delivered_frame(tree):
    """With ``release_outputs`` a delivered frame's HR array is freed
    before the call returns: by the time frame 2 is handed over, nothing
    of the call still holds frame 0."""
    frames = list(_frames(16, 3, 16, 24))
    refs, alive = {}, {}

    def done(i, out):
        refs[i] = weakref.ref(out)
        if i == 2:
            gc.collect()
            alive[0] = refs[0]() is not None
    outs = api.upscale_batch(frames, weights=tree, chunk=1, device="cpu",
                             release_outputs=True, on_image_done=done)
    assert outs == [None, None, None]
    assert alive == {0: False}


def test_float_frames_give_float_out(tree):
    img = _frames(15, 1, 24, 32)[0]
    out = api.upscale(img.astype(np.float32) / 255.0, tree, device="cpu")
    assert out.dtype == np.float32 and 0.0 <= out.min() <= out.max() <= 1.0
    u8 = api.upscale(img, tree, device="cpu")
    gap = np.abs(np.floor(out * 255.0 + 0.5) - u8.astype(np.float32))
    assert gap.max() <= 1.0


def test_group_residual_aliasing_the_stream_fails(tree, monkeypatch):
    """A planted fault: each group's first add written into the group's
    input in place, so that its residual ``r`` aliases the stream and the
    group adds its own output twice; the comparison of
    `test_model_matches_the_reference` must catch it in both tiers."""
    block = swinir._block
    monkeypatch.setattr(swinir, "_block", lambda *a, **k: block(
        *a, **dict(k, fresh=False)))
    frames = _frames(3, 2, 24, 32)
    want = _reference(tree, frames)
    for fast in (False, True):
        assert not _within(_model(tree, frames, fast), want, fast)


def _count_norms(monkeypatch, tree, frames, fast=True, as_kernel=False):
    """Calls of the add-and-normalise in one forward, by form ((add,
    norm) pairs), and ``F.layer_norm`` calls anywhere in it.
    ``as_kernel``: count the calls of the wrapper, which the fast tier
    calls on every device (its argument checks, then the plain version on
    the CPU), in place of its plain version's."""
    al = swinir.add_layernorm
    forms, norms = [], [0]
    ref_fn, wrap_fn, ln = al.add_layernorm_reference, al.add_layernorm, \
        torch.nn.functional.layer_norm

    def spy(fn):
        def run(x, y=None, norm=None, *a):
            forms.append((y is not None, norm is not None))
            return fn(x, y, norm, *a)
        return run

    def count_ln(*a, **k):
        norms[0] += 1
        return ln(*a, **k)

    monkeypatch.setattr(torch.nn.functional, "layer_norm", count_ln)
    if as_kernel:
        monkeypatch.setattr(al, "add_layernorm", spy(wrap_fn))
    else:
        monkeypatch.setattr(al, "add_layernorm_reference", spy(ref_fn))
    net = swinir.prepare(tree, "cpu", fast)
    out = swinir.forward(net, torch.from_numpy(frames), to_u8=False)
    return forms, norms[0], out


@pytest.fixture(scope="module")
def tree_m():
    """Seeded weights at SwinIR-M's published widths."""
    cfg = dict(CFG, embed_dim=180, depths=[6] * 6, num_heads=[6] * 6,
               num_feat=64)
    return ref.draw_weights(2 ** 31 + 17, cfg)


@pytest.mark.parametrize("as_kernel", [False, True])
def test_fast_forward_normalises_80_times_a_frame(tree_m, monkeypatch,
                                                  as_kernel):
    """SwinIR-M's fast forward on one frame: 2 * 36 + 6 adds fused with a
    LayerNorm or the groups' casts, and 2 without an add (the patch
    embedding's norm and block 0's norm1); every LayerNorm is one of
    them.  Through the wrapper as the card runs it, the model's arguments
    pass its checks and the output does not change."""
    frames = _frames(20, 1, 16, 16)
    forms, n_ln, out = _count_norms(monkeypatch, tree_m, frames,
                                    as_kernel=as_kernel)
    assert len(forms) == 80
    # norm2 in each block, the next norm1 in all but each group's last,
    # and the norm after each group's residual
    assert forms.count((True, True)) == 36 + 30 + 6
    assert forms.count((True, False)) == 6          # the groups' casts
    assert forms.count((False, True)) == 2
    assert n_ln == 74
    if as_kernel:
        monkeypatch.undo()
        np.testing.assert_array_equal(
            out, _model(tree_m, frames, True))


def test_exact_forward_keeps_f32_layer_norm(tree, monkeypatch):
    """The exact tier takes the plain version too: 2 groups of 2 blocks
    make 2 * 4 + 2 adds and 2 norms without one; all but the 2 groups'
    casts are LayerNorms."""
    frames = _frames(21, 1, 16, 16)
    forms, n_ln, _ = _count_norms(monkeypatch, tree, frames, fast=False)
    assert len(forms) == 12 and n_ln == 10
    assert forms.count((True, False)) == 2


@pytest.mark.parametrize("wrap", ["params_ema", "params", None])
def test_official_layout_loads(tree, tmp_path, wrap):
    """A checkpoint as `torch.save` writes it, with the index and mask
    buffers the released files carry, wrapped or bare."""
    path = str(tmp_path / "swinir.pth")
    torch.save({wrap: tree} if wrap else tree, path)
    loaded = load_pth(path)
    assert set(loaded) == set(tree)
    assert whole_frame_model(loaded) is swinir
    assert swinir.config_of(loaded)["depths"] == [2, 2]
    img = _frames(10, 1, 24, 32)[0]
    np.testing.assert_array_equal(
        api.upscale(img, path, device="cpu", fast=True),
        api.upscale(img, tree, device="cpu", fast=True))
    assert params.weights_factor(loaded) == 4


def test_full_size_tree_has_the_published_widths():
    cfg = dict(CFG, embed_dim=180, depths=[6] * 6, num_heads=[6] * 6,
               num_feat=64)
    p = ref.draw_weights(1, cfg)
    assert ref.num_parameters(p) == 11_900_199
    got = swinir.config_of(p)
    assert (got["embed_dim"], got["depths"], got["num_heads"],
            got["window_size"], got["mlp_hidden"], got["num_feat"],
            got["upscale"]) == (180, [6] * 6, [6] * 6, 8, 360, 64, 4)


def test_factor_follows_the_weights(tree):
    assert params.weights_factor(tree) == 4
    assert params.weights_factor(params.init_params(0, 2), 2) == 2
    with pytest.raises(ValueError, match="x4, not x3"):
        api.upscale(_frames(11, 1, 16, 16)[0], tree, 3, device="cpu")
    with pytest.raises(ValueError, match="xla"):
        api.upscale(_frames(11, 1, 16, 16)[0], tree, engine="fused",
                    device="cpu")


@pytest.mark.parametrize("engine", ["fused", "int8"])
def test_tiled_sr_runs_swinir_on_the_xla_engine_only(tree, engine):
    """`parallel.tiling` decides the network: SwinIR weights on another
    engine raise there, before any weight is prepared."""
    img = _frames(15, 1, 16, 16)[0].astype(np.float32) / 255.0
    with pytest.raises(ValueError, match=f"'xla' engine only, not "
                                         f"'{engine}'"):
        tiling.tiled_sr(tree, img, 4, engine=engine, device="cpu")


def test_masks_and_index_match_swinir():
    np.testing.assert_array_equal(wa.relative_index(8),
                                  ref.relative_position_index(8))
    for h, w in ((16, 24), (8, 8), (40, 32)):
        np.testing.assert_array_equal(
            wa.shift_mask(h, w, 4), ref.calculate_mask(h, w, 8, 4))


def test_whole_frames_are_the_tiles(tree, monkeypatch):
    """One chunk-loop call a frame size, a frame a tile, no halo."""
    seen = []
    real = tiling._run_chunks

    def spy(devices, n_tiles, chunk, in_specs, out_spec, *a):
        seen.append((n_tiles, chunk, in_specs[0][0], out_spec[0]))
        return real(devices, n_tiles, chunk, in_specs, out_spec, *a)

    monkeypatch.setattr(tiling, "_run_chunks", spy)
    frames = [_frames(12, 1, 24, 32)[0]] * 3 + [_frames(13, 1, 37, 45)[0]]
    api.upscale_batch(frames, weights=tree, chunk=2, device="cpu")
    assert seen == [(3, 2, (2, 24, 32, 3), (2, 96, 128, 3)),
                    (1, 1, (1, 37, 45, 3), (1, 148, 180, 3))]
    assert swinir.HALO == 0 and tiling.HALO == 7


def test_reference_copy_is_the_benchmarks():
    assert filecmp.cmp(os.path.join(ROOT, "tests", "swinir_reference.py"),
                       os.path.join(ROOT, "portbench", "reference",
                                    "swinir.py"), shallow=False)


def test_cli_upscales_with_a_swinir_pth(tree, tmp_path):
    from rusty_sr_tpu_torch.utils.imageio import load_image_u8, \
        save_image_u8
    img = _frames(14, 1, 20, 28)[0]
    src, dst = str(tmp_path / "in.png"), str(tmp_path / "out.png")
    pth = str(tmp_path / "tiny.pth")
    save_image_u8(src, img)
    torch.save({"params": tree}, pth)
    p = subprocess.run([sys.executable, "-m", "rusty_sr_tpu_torch.cli",
                        "--platform", "cpu", "--fast", "-c", pth, src, dst],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    out = load_image_u8(dst)
    assert out.shape == (80, 112, 3)        # x4, from the checkpoint
    np.testing.assert_array_equal(out, api.upscale(img, tree, fast=True,
                                                   device="cpu"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 4])
def test_window_attn_kernel_matches_plain(cuda_device, shift):
    """The cell's frame, 960x540 padded to 544x960 (8,160 windows), 6
    heads of 30, against the plain version on the same bf16 inputs in
    float32.  Bound: the kernel rounds P to bf16 before P v and its
    output to bf16 (2^-9 relative each, outputs up to ~4): 2e-2 largest,
    2e-3 mean."""
    g = torch.Generator().manual_seed(shift)
    qkv = torch.randn(1, 544 * 960, 540, generator=g).to(cuda_device,
                                                         torch.bfloat16)
    bias = wa.relative_bias(torch.randn(225, 6, generator=g).to(cuda_device))
    n = wa.LAUNCHES
    out = wa.window_attn(qkv, bias, shift, 544, 960)
    torch.cuda.synchronize()
    assert wa.LAUNCHES == n + 1
    want = wa.window_attn_reference(qkv.float(), bias, shift, 544, 960)
    d = (out.float() - want).abs()
    assert float(d.max()) <= 2e-2 and float(d.mean()) <= 2e-3
    if shift:       # the shift is not a no-op at this size
        unshifted = wa.window_attn_reference(qkv.float(), bias, 0, 544, 960)
        assert float((out.float() - unshifted).abs().max()) > 0.1
