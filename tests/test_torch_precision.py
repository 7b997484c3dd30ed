"""``train --precision high`` in the port: the three-term bf16 split
convolution (`ops.conv.conv2d_bf16x3`) and the training step that runs
on it, against float64 and against the JAX package's
``precision="high"`` step.

Bounds:
- the split convolution, its input gradient and its weight gradient
  against float64: within 2^-16 of sum |a||b| over each output's
  products (the dropped lo*lo term and the rounding of lo are 2^-18 of a
  product each; f32 sums);
- the split's error is at least 100x below plain bf16's (one rounding of
  each operand, 2^-9) on the same operands;
- one step against JAX's: loss rel 1e-5, each gradient leaf within 1e-4
  of that leaf's largest magnitude.  JAX on the CPU computes HIGH as
  float32, so this bound is the split's error plus f32 sums; the same
  bound holds against the port's float64 step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rusty_sr_tpu.train import loop as JL
from rusty_sr_tpu_torch import api, cli
from rusty_sr_tpu_torch.ops import conv as C
from rusty_sr_tpu_torch.params import init_params
from rusty_sr_tpu_torch.train import loop as TL
from rusty_sr_tpu_torch.utils.imageio import save_image_u8


def conv64(x, w):
    return C.conv2d_same(x.double(), w.double())


def operands(seed, n, h, w, ci, co, k):
    r = np.random.default_rng(seed)
    x = torch.tensor(r.standard_normal((n, h, w, ci)), dtype=torch.float32)
    wt = torch.tensor(r.standard_normal((k, k, ci, co)) * 0.1,
                      dtype=torch.float32)
    g = torch.tensor(r.standard_normal((n, h, w, co)), dtype=torch.float32)
    return x, wt, g


def split_and_exact(x, w, g):
    """(the split's, float64's) output, input and weight gradients, and
    each one's sum |a||b| over its products."""
    xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = C.conv2d_bf16x3(xs, ws)
    dx, dw = torch.autograd.grad(y, (xs, ws), g)
    x64, w64 = (t.double().requires_grad_() for t in (x, w))
    y64 = conv64(x64, w64)
    dx64, dw64 = torch.autograd.grad(y64, (x64, w64), g.double())
    xa, wa = x.double().abs().requires_grad_(), w.double().abs()\
        .requires_grad_()
    ya = conv64(xa, wa)
    dxa, dwa = torch.autograd.grad(ya, (xa, wa), g.double().abs())
    return [(a.detach().double(), b.detach(), s.detach())
            for a, b, s in ((y, y64, ya), (dx, dx64, dxa), (dw, dw64, dwa))]


@pytest.mark.parametrize("shape", [(2, 9, 10, 5, 7, 3), (1, 12, 8, 3, 32, 5),
                                   (2, 6, 6, 32, 27, 3)],
                         ids=["k3", "conv0-k5", "expand-k3"])
def test_split_conv_and_gradients_within_2e16_of_float64(shape):
    x, w, g = operands(0, *shape)
    for name, (got, want, scale) in zip(("y", "dx", "dw"),
                                        split_and_exact(x, w, g)):
        err = (got - want).abs()
        assert bool((err <= 2.0 ** -16 * scale).all()), \
            (name, float((err / scale.clamp_min(1e-30)).max()))


def test_split_is_100x_closer_than_bf16():
    x, w, g = operands(1, 2, 16, 16, 32, 32, 3)
    (got, want, _), _, _ = split_and_exact(x, w, g)
    bf16 = C.conv2d_same(x.bfloat16(), w.bfloat16()).double()
    split_err = float((got - want).abs().max())
    bf16_err = float((bf16 - want).abs().max())
    assert split_err * 100 <= bf16_err, (split_err, bf16_err)


def test_split_conv_takes_float32_only():
    x, w, _ = operands(2, 1, 4, 4, 3, 4, 3)
    with pytest.raises(ValueError, match="float32"):
        C.conv2d_bf16x3(x.double(), w.double())


def port_value_and_grad(params, hr, cfg, dtype=torch.float32):
    p = {k: torch.tensor(v, dtype=dtype, requires_grad=True)
         for k, v in params.items()}
    x = torch.from_numpy(hr).to(dtype)
    with TL.step_precision(cfg):
        loss, _ = TL.loss_fn(p, x, cfg)
        grads = torch.autograd.grad(loss, list(p.values()))
    return float(loss.detach()), {k: g.double().numpy()
                                  for k, g in zip(p, grads)}


def float64_value_and_grad(params, hr, cfg):
    """The port's loss on float64 parameters and batch, every
    convolution an exact float64 one: the step the split approximates."""
    from rusty_sr_tpu_torch.models import sr_net
    saved = sr_net.conv2d_bf16x3
    sr_net.conv2d_bf16x3 = C.conv2d_same
    try:
        return port_value_and_grad(params, hr, cfg, torch.float64)
    finally:
        sr_net.conv2d_bf16x3 = saved


@pytest.mark.parametrize("trunk", ["merged", "flat"])
def test_high_step_matches_jax_and_float64(trunk):
    params = init_params(0, 3, width=8)
    hr = np.random.default_rng(1).random((2, 24, 24, 3), dtype=np.float32)
    kw = dict(factor=3, batch_size=2, crop=24, trunk=trunk, precision="high")
    loss, grads = port_value_and_grad(params, hr, TL.TrainConfig(**kw))
    (j_loss, _), j_grads = jax.value_and_grad(JL.loss_fn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(hr),
        JL.TrainConfig(**kw))
    l64, g64 = float64_value_and_grad(params, hr, TL.TrainConfig(**kw))
    for ref_loss, ref in ((float(j_loss), j_grads), (l64, g64)):
        assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
        for k, g in grads.items():
            r = np.asarray(ref[k], np.float64)
            assert float(np.abs(g - r).max()) <= 1e-4 * float(
                np.abs(r).max()), k


def test_high_is_closer_to_float64_than_amp():
    """The witness that the split is not the bf16 tier: its worst leaf is
    100x nearer the float64 gradient than ``--amp``'s."""
    params = init_params(2, 3, width=8)
    hr = np.random.default_rng(3).random((2, 24, 24, 3), dtype=np.float32)
    _, g64 = float64_value_and_grad(params, hr, TL.TrainConfig(crop=24))

    def worst(cfg):
        _, g = port_value_and_grad(params, hr, cfg)
        return max(float(np.abs(g[k] - g64[k]).max())
                   / float(np.abs(g64[k]).max()) for k in g)
    high = worst(TL.TrainConfig(crop=24, precision="high"))
    amp = worst(TL.TrainConfig(crop=24, amp=True))
    assert high * 100 <= amp, (high, amp)


@pytest.mark.parametrize("kw", [dict(amp=True), dict(trunk="packed")],
                         ids=["amp", "packed"])
def test_amp_and_packed_ignore_precision(kw):
    params = init_params(4, 3, width=8)
    hr = np.random.default_rng(5).random((2, 24, 24, 3), dtype=np.float32)
    a = port_value_and_grad(params, hr, TL.TrainConfig(crop=24, **kw))
    b = port_value_and_grad(params, hr, TL.TrainConfig(
        crop=24, precision="high", **kw))
    assert a[0] == b[0]
    for k in a[1]:
        assert a[1][k].tobytes() == b[1][k].tobytes(), k


def test_high_step_keeps_tf32_to_the_split(monkeypatch):
    """TF32 is allowed inside the split's products alone: the step's
    other work (the pair synthesis, the backward pass outside the split)
    runs under `exact_f32`, as the f32 tier's does."""
    from rusty_sr_tpu_torch.models import sr_net
    seen = {"split": set(), "outside": set()}
    split_terms = C._bf16_3

    def terms(*a):
        seen["split"].add(torch.backends.cudnn.allow_tf32)
        return split_terms(*a)

    def make_lr(hr, f):
        seen["outside"].add(torch.backends.cudnn.allow_tf32)
        return sr_net.make_lr_from_hr(hr, f)

    monkeypatch.setattr(C, "_bf16_3", terms)
    monkeypatch.setattr(TL, "make_lr_from_hr", make_lr)
    params = init_params(0, 3, width=8)
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    hr = torch.rand((1, 24, 24, 3), generator=torch.Generator().manual_seed(0))
    cfg = TL.TrainConfig(crop=24, precision="high")
    with TL.step_precision(cfg):
        loss, _ = TL.loss_fn(p, hr, cfg)
        loss.register_hook(lambda g: seen["outside"].add(
            torch.backends.cudnn.allow_tf32))
        loss.backward()
    assert seen == {"split": {True}, "outside": {False}}


def test_precision_config_checked():
    with pytest.raises(ValueError, match="precision"):
        TL.loss_fn({}, torch.zeros(1, 6, 6, 3),
                   TL.TrainConfig(precision="medium"))


@pytest.fixture
def folder(tmp_path):
    d = tmp_path / "ti"
    d.mkdir()
    r = np.random.default_rng(6)
    for i in range(3):
        save_image_u8(str(d / f"t{i}.png"),
                      r.integers(0, 256, (60, 75, 3), dtype=np.uint8))
    return str(d)


def test_cli_train_precision_high(folder, tmp_path, capsys):
    out = tmp_path / "o.rsr"
    assert cli.main(["train", "--platform", "cpu", "--precision", "high",
                     "--crop", "24", "--max_steps", "2", "-v", folder, "-m",
                     "1", str(out), folder]) == 0
    assert "Validation PSNR:" in capsys.readouterr().out
    assert out.stat().st_size == 1_043_676


@pytest.mark.parametrize("trunk", ["merged", "flat"])
def test_api_train_folder_precision_high(folder, trunk):
    """``train_folder(precision="high")`` from the same start and feed as
    the exact tier ends within 1e-4 of it after three steps (the tiers'
    gradients differ by the split's error; Adam's steps stay the same
    but for entries that cancel to near zero)."""
    start = init_params(1, 3, width=8)
    trees = [api.train_folder(folder, steps=3, crop=24, batch_size=2,
                              start=start, trunk=trunk, precision=prec,
                              data_workers=1, device="cpu")
             for prec in ("highest", "high")]
    moved = max(float(np.abs(trees[0][k] - start[k]).max()) for k in start)
    assert moved > 1e-3
    for k in start:
        np.testing.assert_allclose(trees[1][k], trees[0][k], rtol=0,
                                   atol=1e-4, err_msg=k)
