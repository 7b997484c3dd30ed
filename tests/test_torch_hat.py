"""HAT (`models/hat.py`) against the plain reference
(`tests/hat_reference.py`) on seeded weights at small sizes on the CPU:
embed width 24, 2 groups of 2 hybrid blocks and an OCAB, 2 heads of 12,
window 4 with 6x6 overlapping keys; and one case at HAT's window 16 and
head width 30 (embed 60).  Through `api.upscale_batch`, the official key
layout, the dispatch that tells HAT from SwinIR, and the CLI.  The tests
marked ``cuda`` hold the two attention kernels and the three-term
add-and-normalise to their plain versions at the benchmark cell's shapes,
on the card:

    python -m pytest --noconftest tests/test_torch_hat.py -q -m cuda

Tolerances, as the largest and the mean absolute gap of the float output
(values in [0, 1]):
- exact tier: 1e-5 of the reference's largest value: the same float32
  arithmetic, summed in other orders (token-major linear layers against
  per-window ones, the channel attention's scale folded before its
  product);
- fast tier: SwinIR's 1.5e-2 largest and 1.5e-3 mean: bf16 GEMM and
  convolution operands (a relative rounding of up to 2^-9 each) through
  6 blocks and 4 convolutions; measured 3.3e-3 to 5.0e-3 and 5.5e-4 to
  7.4e-4 on these weights.  Every planted fault reads 0.035-0.20 largest
  and 3.4e-3 to 2.9e-2 mean against the fast tier, so both tiers see each
  one (the reference's draw makes the branch of the attention's order).
"""

import filecmp
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import hat_reference as ref  # noqa: E402

from rusty_sr_tpu_torch import api, params  # noqa: E402
from rusty_sr_tpu_torch.models import (hat, load_pth, swinir,  # noqa: E402
                                       whole_frame_model)
from rusty_sr_tpu_torch.ops.cuda import add_layernorm as al  # noqa: E402
from rusty_sr_tpu_torch.ops.cuda import hat_attn as ha  # noqa: E402
from rusty_sr_tpu_torch.parallel import tiling  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(embed_dim=24, in_chans=3, window_size=4, overlap_ratio=0.5,
           compress_ratio=3, squeeze_factor=6, conv_scale=0.01,
           depths=[2, 2], num_heads=[2, 2], mlp_ratio=2, num_feat=16,
           upscale=4, out_chans=3, img_size=64, img_range=1.0,
           mean=[0.4488, 0.4371, 0.4040])
# HAT's own window and head width on one group.
CFG16 = dict(CFG, embed_dim=60, window_size=16, depths=[2], num_heads=[2],
             squeeze_factor=30)
EXACT_REL = 1e-5
FAST_MAX, FAST_MEAN = 1.5e-2, 1.5e-3


@pytest.fixture(scope="module")
def tree():
    return ref.draw_weights(2 ** 31 + 23, CFG)


@pytest.fixture(scope="module")
def tree16():
    return ref.draw_weights(2 ** 31 + 29, CFG16)


def _frames(seed, n, h, w):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3),
                                                dtype=np.uint8)


def _reference(p, frames, cfg=CFG, fault=None):
    x = torch.from_numpy(frames).permute(0, 3, 1, 2).float() / 255.0
    with ref.exact(), torch.no_grad():
        return ref.forward(p, x, cfg, fault=fault).permute(0, 2, 3, 1)


def _model(p, frames, fast):
    return hat.forward(hat.prepare(p, "cpu", fast), torch.from_numpy(frames),
                       to_u8=False)


def _within(out, want, fast) -> bool:
    d = (out - want).abs()
    if fast:
        return float(d.max()) <= FAST_MAX and float(d.mean()) <= FAST_MEAN
    return float(d.max()) <= EXACT_REL * float(want.abs().max())


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("size", [(20, 28), (18, 26)])
def test_model_matches_the_reference(tree, fast, size):
    """Both tiers; 20x28 is whole windows of 4, 18x26 is not, so that
    frame is reflect-padded and the output cropped."""
    frames = _frames(3, 2, *size)
    out = _model(tree, frames, fast)
    want = _reference(tree, frames)
    assert out.shape == (2, 4 * size[0], 4 * size[1], 3)
    assert _within(out, want, fast)


@pytest.mark.parametrize("fast", [False, True])
def test_window_16_matches_the_reference(tree16, fast):
    """HAT's window 16 (24x24 overlapping keys, shift 8) and head width
    30 on a 34x50 frame, padded to 48x64: 12 windows, of which every
    border window reaches outside the frame."""
    frames = _frames(4, 1, 34, 50)
    assert _within(_model(tree16, frames, fast), _reference(
        tree16, frames, CFG16), fast)


@pytest.mark.parametrize("fault", ref.FAULTS)
def test_planted_faults_fail_the_exact_comparison(tree, fault):
    frames = _frames(5, 2, 20, 28)
    assert not _within(_model(tree, frames, False),
                       _reference(tree, frames, fault=fault), False), fault


@pytest.mark.parametrize("fault", ref.FAULTS)
def test_planted_faults_fail_the_fast_comparison(tree, fault):
    frames = _frames(5, 2, 20, 28)
    assert not _within(_model(tree, frames, True),
                       _reference(tree, frames, fault=fault), True), fault


@pytest.mark.parametrize("size", [(12, 16), (8, 8), (20, 12)])
def test_oca_plain_version_matches_the_references_unfold(size):
    """`hat_attn_reference`'s overlapping form (keys cut by
    `Tensor.unfold` from the zero-padded grid) against the reference's
    ``nn.Unfold`` path on the same qkv, every border window included; 8x8
    is two windows a side, each reaching outside the grid on two sides."""
    g = torch.Generator().manual_seed(size[0])
    h, w = size
    heads, c = 2, 24
    qkv = torch.randn(2, h * w, 3 * c, generator=g)
    table = torch.randn(81, heads, generator=g)
    got = ha.hat_attn_reference(qkv, ha.offset_table(table, 4, 6), 0, h, w,
                                4, 6)
    with torch.no_grad():
        want = ref.overlap_attention(qkv.view(2, h, w, 3 * c), table,
                                     ref.calculate_rpi_oca(4, 0.5), CFG,
                                     heads)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shift", [0, 2])
def test_sa_plain_version_matches_window_partition(shift):
    """The self-attention form against roll, `window_partition` and the
    reference's bias and mask, written out here."""
    g = torch.Generator().manual_seed(shift)
    h, w, heads, c, ws = 8, 12, 2, 24, 4
    qkv = torch.randn(1, h * w, 3 * c, generator=g)
    table = torch.randn(49, heads, generator=g)
    got = ha.hat_attn_reference(qkv, ha.offset_table(table, ws, ws), shift,
                                h, w, ws, ws)
    x = torch.roll(qkv.view(1, h, w, 3 * c), (-shift, -shift), (1, 2))
    xw = ref.window_partition(x, ws).view(-1, ws * ws, 3, heads, c // heads)
    q, k, v = xw.permute(2, 0, 3, 1, 4)
    bias = table[ref.calculate_rpi_sa(ws).view(-1)].view(
        ws * ws, ws * ws, heads).permute(2, 0, 1)
    a = (q * (c // heads) ** -0.5) @ k.transpose(-2, -1) + bias
    if shift:
        a = a + ref.calculate_mask(h, w, ws, shift).unsqueeze(1)
    o = (torch.softmax(a, -1) @ v).transpose(1, 2).reshape(-1, ws, ws, c)
    want = torch.roll(ref.window_reverse(o, ws, h, w), (shift, shift),
                      (1, 2)).reshape(1, h * w, c)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ws, ratio", [(16, 0.5), (4, 0.5), (8, 0.5)])
def test_rpi_oca_reaches_each_row_once(ws, ratio):
    """`calculate_rpi_oca` as published (its offset w - kw + 1 makes some
    indices negative) reaches each of the (w + kw - 1)^2 table rows
    exactly once after wrapping: 1,521 at window 16.  The port's index
    equals the reference's, and its offset table holds every row once."""
    kw = ws + int(ws * ratio)
    rows = (ws + kw - 1) ** 2
    rpi = ref.calculate_rpi_oca(ws, ratio)
    assert int(rpi.min()) < 0
    np.testing.assert_array_equal(ha.overlap_index(ws, kw), rpi)
    tab = ha.offset_table(torch.arange(rows, dtype=torch.float32)[:, None],
                          ws, kw)
    assert sorted(tab[0].long().tolist()) == list(range(rows))
    # the slots that the (query, key) pairs reach, each a single row
    slots = ha._slots(ws, kw)
    for s, r in ((int(a), int(b)) for a, b in zip(
            slots.reshape(-1)[::97], rpi.reshape(-1)[::97] % rows)):
        assert int(tab[0, s]) == r
    if ws == 16:
        assert rows == 1521
        sa = ha.offset_table(torch.arange(961.0)[:, None], 16, 16)
        assert sorted(sa[0].long().tolist()) == list(range(961))


@pytest.mark.parametrize("fast", [False, True])
def test_two_frames_in_one_chunk_equal_each_alone(tree, fast):
    """The channel attention's mean is a frame's own: a dark and a bright
    frame in one chunk give each one's output alone."""
    dark = (_frames(6, 1, 20, 28) // 4).astype(np.uint8)
    bright = (255 - _frames(7, 1, 20, 28) // 4).astype(np.uint8)
    both = _model(tree, np.concatenate([dark, bright]), fast)
    for i, one in enumerate((dark, bright)):
        torch.testing.assert_close(both[i:i + 1], _model(tree, one, fast),
                                   rtol=0, atol=1e-5)


def test_config_of_reads_every_width():
    cfg = dict(CFG, embed_dim=48, depths=[3, 1], num_heads=[4, 6],
               window_size=8, compress_ratio=4, squeeze_factor=8,
               mlp_ratio=3, num_feat=32, upscale=2)
    got = hat.config_of({"params_ema": ref.draw_weights(1, cfg)})
    assert {k: got[k] for k in (
        "embed_dim", "in_chans", "depths", "num_heads", "window_size",
        "overlap_window", "mlp_hidden", "num_feat", "upscale", "out_chans",
        "compress", "squeeze", "conv_scale", "overlap_ratio")} == {
        "embed_dim": 48, "in_chans": 3, "depths": [3, 1],
        "num_heads": [4, 6], "window_size": 8, "overlap_window": 12,
        "mlp_hidden": 144, "num_feat": 32, "upscale": 2, "out_chans": 3,
        "compress": 12, "squeeze": 6, "conv_scale": 0.01,
        "overlap_ratio": 0.5}
    bad = ref.draw_weights(1, dict(cfg, overlap_ratio=0.25))
    with pytest.raises(ValueError, match="overlap ratio"):
        hat.config_of(bad)


def test_full_size_tree_has_the_published_widths():
    cfg = dict(CFG, embed_dim=180, window_size=16, depths=[6] * 6,
               num_heads=[6] * 6, squeeze_factor=30, num_feat=64)
    p = ref.draw_weights(1, cfg)
    assert ref.num_parameters(p) == 20_772_507
    got = hat.config_of(p)
    assert (got["embed_dim"], got["depths"], got["num_heads"],
            got["window_size"], got["overlap_window"], got["mlp_hidden"],
            got["compress"], got["squeeze"], got["num_feat"],
            got["upscale"]) == (180, [6] * 6, [6] * 6, 16, 24, 360, 60, 6,
                                64, 4)


@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("norm", [True, False])
def test_three_term_add_layernorm_plain(in_place, norm):
    """The plain version's third term: s = (x + y) + k[frame] * (z + b),
    each step rounded on its own, then LN(s) (or the cast); through the op
    on the CPU too."""
    g = torch.Generator().manual_seed(int(in_place) + 2 * int(norm))
    f, n, c = 2, 10, 12
    x = torch.randn(f, n, c, generator=g) * 3
    y = torch.randn(f, n, c, generator=g).to(torch.bfloat16)
    z = torch.randn(f, n, c, generator=g).to(torch.bfloat16)
    k = torch.rand(f, c, generator=g) * 0.01
    b = torch.randn(c, generator=g) * 0.05
    wb = (1 + 0.1 * torch.randn(c, generator=g), 0.1 * torch.randn(c,
                                                                 generator=g))
    want = (x + y.float()) + k[:, None, :] * (z.float() + b)
    h_want = F.layer_norm(want, (c,), *wb, 1e-5) if norm else want
    for fn in (al.add_layernorm_reference, al.add_layernorm):
        xi = x.clone()
        s, h = fn(xi, y, wb if norm else None, torch.float32,
                  xi if in_place else None, 1e-5, z, k, b)
        assert torch.equal(s, want) and torch.equal(h, h_want)
        assert (s.data_ptr() == xi.data_ptr()) == in_place
        if not in_place:
            assert torch.equal(xi, x)


@pytest.mark.parametrize("norm", [True, False])
def test_add_layernorm_wide_rows_end_in_zeros(norm):
    """``h_width``: h's rows widened with zero columns (the fast tier's
    184-wide copies of 180 channels), the values those of the narrow h."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 5, 12, generator=g)
    y = torch.randn(2, 5, 12, generator=g).to(torch.bfloat16)
    wb = (torch.ones(12), torch.zeros(12)) if norm else None
    _, narrow = al.add_layernorm(x.clone(), y, wb)
    _, wide = al.add_layernorm(x.clone(), y, wb, h_width=16)
    assert wide.shape == (2, 5, 16)
    assert torch.equal(wide[..., :12], narrow)
    assert not wide[..., 12:].any()
    with pytest.raises(ValueError, match="h_width"):
        al.add_layernorm(x, y, wb, h_width=14)


def test_three_term_add_layernorm_checks():
    x = torch.zeros(2, 3, 4)
    y = torch.zeros(2, 3, 4, dtype=torch.bfloat16)
    b = torch.zeros(4)
    with pytest.raises(ValueError, match="come together"):
        al.add_layernorm(x, y, z=y, z_bias=b)
    with pytest.raises(ValueError, match="z_scale must be"):
        al.add_layernorm(x, y, z=y, z_scale=torch.zeros(3, 4), z_bias=b)
    with pytest.raises(ValueError, match="z_bias must be"):
        al.add_layernorm(x, y, z=y, z_scale=torch.zeros(2, 4),
                         z_bias=torch.zeros(3))
    with pytest.raises(ValueError, match="only with y"):
        al.add_layernorm(x, z=y, z_scale=torch.zeros(2, 4), z_bias=b)


def test_dispatch_tells_hat_from_swinir(tree):
    """A HAT state dict holds SwinIR's ``conv_first`` and block keys: it
    is HAT's, never SwinIR's, and SwinIR's stays SwinIR's."""
    import swinir_reference as sref
    swin = sref.draw_weights(1, dict(CFG, window_size=8, num_heads=[3, 3]))
    assert hat.is_hat(tree) and not swinir.is_swinir(tree)
    assert swinir.is_swinir(swin) and not hat.is_hat(swin)
    assert whole_frame_model({"params_ema": tree}) is hat
    assert whole_frame_model(swin) is swinir
    assert whole_frame_model(params.init_params(0, 3)) is None
    with pytest.raises(ValueError, match="not a SwinIR"):
        swinir.config_of(tree)
    with pytest.raises(ValueError, match="not a HAT"):
        hat.config_of(swin)


def test_grid_routes_hat_to_its_model_on_the_exact_tier(tree, monkeypatch):
    """`parallel.tiling._grid` sends HAT weights to `_whole_frames_batch`
    with `models.hat`, a frame a tile: the exact tier through
    `api.upscale_batch` gives `hat.forward`'s output."""
    seen = []
    real = tiling._whole_frames_batch

    def spy(model, *a, **k):
        seen.append(model)
        return real(model, *a, **k)
    monkeypatch.setattr(tiling, "_whole_frames_batch", spy)
    frames = _frames(8, 2, 18, 26)
    outs = api.upscale_batch(list(frames), weights=tree, device="cpu")
    assert seen == [hat]
    net = hat.prepare(tree, "cpu", False)
    for o, im in zip(outs, frames):     # one frame a chunk
        np.testing.assert_array_equal(
            o, hat.forward(net, torch.from_numpy(im[None])).numpy()[0])
    assert hat.HALO == 0 and hat.DEFAULT_CHUNK == 1


def test_factor_and_engine_follow_the_weights(tree):
    assert params.weights_factor(tree) == 4
    with pytest.raises(ValueError, match="HAT weights upscale x4, not x3"):
        api.upscale(_frames(9, 1, 16, 16)[0], tree, 3, device="cpu")
    img = _frames(9, 1, 16, 16)[0].astype(np.float32) / 255.0
    with pytest.raises(ValueError, match="HAT runs on the 'xla' engine"):
        tiling.tiled_sr(tree, img, 4, engine="fused", device="cpu")


@pytest.mark.parametrize("wrap", ["params_ema", None])
def test_official_layout_loads(tree, tmp_path, wrap):
    """A checkpoint as `torch.save` writes it, with HAT's index buffers,
    through `models.load_pth`, which the program loads them with, and a
    path to `api.upscale`."""
    path = str(tmp_path / "hat.pth")
    torch.save({wrap: tree} if wrap else tree, path)
    loaded = load_pth(path)
    assert set(loaded) == set(tree)
    assert whole_frame_model(loaded) is hat
    img = _frames(10, 1, 16, 20)[0]
    np.testing.assert_array_equal(
        api.upscale(img, path, device="cpu", fast=True),
        api.upscale(img, tree, device="cpu", fast=True))


@pytest.mark.parametrize("key_window", [4, 6])
def test_attention_reads_wide_rows_and_pads_its_output(key_window):
    """The fast tier's padded rows: qkv's first 3C channels of wider rows
    read, the output widened with zero columns; the values are those of
    the narrow call."""
    g = torch.Generator().manual_seed(key_window)
    qkv = torch.randn(1, 64, 72, generator=g)
    tab = ha.offset_table(torch.randn((3 + key_window) ** 2, 2, generator=g),
                          4, key_window)
    narrow = ha.hat_attn_reference(qkv, tab, 0, 8, 8, 4, key_window)
    wide_in = torch.cat([qkv, torch.randn(1, 64, 8, generator=g)], -1)
    got = ha.hat_attn_reference(wide_in, tab, 0, 8, 8, 4, key_window,
                                channels=24, out_width=32)
    assert got.shape == (1, 64, 32) and not got[..., 24:].any()
    assert torch.equal(got[..., :24], narrow)


def test_kernels_refuse_what_they_do_not_take():
    qkv = torch.zeros(1, 64, 72)
    tab = torch.zeros(2, 49)
    with pytest.raises(ValueError, match="whole 4x4 windows"):
        ha.sa_attn(qkv, tab, 0, 8, 7, 4)
    with pytest.raises(ValueError, match="shift 2 for 4/6 windows"):
        ha._launch(qkv, torch.zeros(2, 81), 2, 8, 8, 4, 6)
    out = ha.sa_attn(qkv, tab, 2, 8, 8, 4)      # the CPU: plain, any window
    assert out.shape == (1, 64, 24) and ha.LAUNCHES_SA == 0


def test_reference_copy_is_the_benchmarks():
    assert filecmp.cmp(os.path.join(ROOT, "tests", "hat_reference.py"),
                       os.path.join(ROOT, "portbench", "reference",
                                    "hat.py"), shallow=False)


def test_reference_imports_nothing_of_the_program():
    code = ("import json, sys; sys.path.insert(0, %r); "
            "import hat_reference; "
            "print(json.dumps(sorted(sys.modules)))"
            % os.path.join(ROOT, "tests"))
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    names = json.loads(p.stdout)
    assert not any(n.split(".")[0] in ("rusty_sr_tpu_torch", "rusty_sr_tpu",
                                       "jax", "jaxlib", "portbench")
                   for n in names)


def test_cli_upscales_with_a_hat_pth(tree, tmp_path):
    from rusty_sr_tpu_torch.utils.imageio import load_image_u8, \
        save_image_u8
    img = _frames(14, 1, 18, 22)[0]
    src, dst = str(tmp_path / "in.png"), str(tmp_path / "out.png")
    pth = str(tmp_path / "tiny_hat.pth")
    save_image_u8(src, img)
    torch.save({"params_ema": tree}, pth)
    p = subprocess.run([sys.executable, "-m", "rusty_sr_tpu_torch.cli",
                        "--platform", "cpu", "--fast", "-c", pth, src, dst],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    out = load_image_u8(dst)
    assert out.shape == (72, 88, 3)
    np.testing.assert_array_equal(out, api.upscale(img, tree, fast=True,
                                                   device="cpu"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("key_window, shift", [(16, 0), (16, 8), (24, 0)])
def test_attention_kernels_match_plain(cuda_device, key_window, shift):
    """The cell's frame, 960x540 padded to 544x960 (2,040 windows), 6
    heads of 30, against the plain version on the same bf16 inputs in
    float32.  Bound as SwinIR's kernel: P and the output rounded to bf16
    (2^-9 relative each): 2e-2 largest, 2e-3 mean."""
    g = torch.Generator().manual_seed(key_window + shift)
    qkv = torch.randn(1, 544 * 960, 540, generator=g).to(cuda_device,
                                                         torch.bfloat16)
    rows = (16 + key_window - 1) ** 2
    tab = ha.offset_table(torch.randn(rows, 6, generator=g), 16,
                          key_window).to(cuda_device)
    n = ha.LAUNCHES_SA + ha.LAUNCHES_OCA
    if key_window == 16:
        out = ha.sa_attn(qkv, tab, shift, 544, 960)
    else:
        out = ha.oca_attn(qkv, tab, 544, 960)
    torch.cuda.synchronize()
    assert ha.LAUNCHES_SA + ha.LAUNCHES_OCA == n + 1
    want = ha.hat_attn_reference(qkv.float(), tab, shift, 544, 960, 16,
                                 key_window)
    d = (out.float() - want).abs()
    assert float(d.max()) <= 2e-2 and float(d.mean()) <= 2e-3
    # the fast tier's rows: qkv 544 wide, the output 192 with zero columns
    wide = torch.cat([qkv, torch.full_like(qkv[..., :4], float("nan"))], -1)
    kw = dict(channels=180, out_width=192)
    out2 = ha.sa_attn(wide, tab, shift, 544, 960, **kw) if key_window == 16 \
        else ha.oca_attn(wide, tab, 544, 960, **kw)
    assert torch.equal(out2[..., :180], out) and not out2[..., 180:].any()


@pytest.mark.cuda
def test_three_term_kernel_matches_plain(cuda_device):
    """The hybrid block's add + norm on one cell frame at C = 180: the sum
    bit-identical to the plain version's, h within one bf16 unit."""
    g = torch.Generator().manual_seed(3)
    n, c = 544 * 960, 180
    x = (torch.randn(1, n, c, generator=g) * 3).to(cuda_device)
    y, z = (torch.randn(1, n, c, generator=g).to(cuda_device, torch.bfloat16)
            for _ in range(2))
    k = (0.01 * torch.rand(1, c, generator=g)).to(cuda_device)
    b = (0.05 * torch.randn(c, generator=g)).to(cuda_device)
    wb = (torch.ones(c, device=cuda_device), torch.zeros(c,
                                                         device=cuda_device))
    s_k, h_k = al.add_layernorm(x, y, wb, torch.bfloat16, None, 1e-5, z, k,
                                b)
    s_p, h_p = al.add_layernorm_reference(x, y, wb, torch.bfloat16, None,
                                          1e-5, z, k, b)
    assert torch.equal(s_k, s_p)
    unit = torch.exp2(torch.floor(torch.log2(
        h_p.float().abs().clamp_min(2.0 ** -126))) - 7).clamp_min(2 ** -20)
    assert bool(((h_k.float() - h_p.float()).abs() <= unit).all())
    # the rows widened to 184 with zero columns, as the fast tier reads them
    _, h_w = al.add_layernorm(x, y, wb, torch.bfloat16, None, 1e-5, z, k, b,
                              184)
    assert torch.equal(h_w[..., :c], h_k) and not h_w[..., c:].any()
