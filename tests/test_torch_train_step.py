"""One training step of the port against the JAX package's.

The same init (width 8) and the same HR batch (made with numpy from a
seed) go through `jax.value_and_grad(rusty_sr_tpu.train.loop.loss_fn)`
and the port's `loss_fn` + autograd.  Tolerances:
- the loss: rtol 1e-5 (float32 sums in another order);
- each gradient leaf: 1e-4 of that leaf's largest magnitude in float32.
  In the bf16 tiers (``amp``, the packed trunk) JAX rounds both
  gradients of each convolution to bf16 (the packed trunk's each copy of
  a weight before the copies are summed) and sums each convolution's
  input gradient over the taps in bf16 (its im2col transpose), where the
  port's convolutions (`ops.conv.conv2d_bf16`) keep both gradients in
  float32 (its step rounds each weight's gradient to bf16 once, after
  this loss's gradient).  So there are two float64 gradients, each with
  every sum in float64: one at the port's rounding points, one at JAX's.
  A bf16 leaf is held to the port's at 1e-3, and to JAX's gradient at
  2e-2 beyond JAX's own distance from the float64 gradient at its
  rounding points (up to 2.3e-2 of a leaf's largest magnitude);
- Adam: parameters to atol 1e-4 after three steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rusty_sr_tpu.train import loop as JL
from rusty_sr_tpu_torch.params import init_params
from rusty_sr_tpu_torch.train import loop as TL


def tree(factor, seed=0):
    return init_params(seed, factor, width=8)


def batch(factor, u8=False, seed=1, n=2, crop=None):
    crop = crop or 8 * factor   # LR side 8: even, for the packed trunk
    r = np.random.default_rng(seed)
    if u8:
        return r.integers(0, 256, (n, crop, crop, 3), dtype=np.uint8)
    return r.random((n, crop, crop, 3), dtype=np.float32)


def port_value_and_grad(params, hr, cfg):
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    loss, mse = TL.loss_fn(p, torch.from_numpy(hr), cfg)
    grads = torch.autograd.grad(loss, list(p.values()))
    return float(loss.detach()), float(mse.detach()), \
        {k: g.numpy() for k, g in zip(p, grads)}


def jax_value_and_grad(params, hr, cfg):
    (loss, mse), grads = jax.value_and_grad(JL.loss_fn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(hr), cfg)
    return float(loss), float(mse), {k: np.asarray(g) for k, g in
                                     grads.items()}


# (trunk, amp, loss kind, linear loss, u8 batch, factor)
STEPS = [("merged", False, "mse", False, False, 3),
         ("merged", False, "mse", False, True, 2),
         ("merged", False, "l1", True, True, 3),
         ("flat", False, "mse", False, True, 3),
         ("flat", False, "l1", False, False, 4),
         ("merged", True, "mse", False, True, 3),
         ("flat", True, "mse", True, True, 2),
         ("packed", False, "mse", False, True, 3),
         ("packed", False, "l1", True, False, 4)]


@pytest.mark.parametrize(
    "trunk,amp,kind,linear,u8,f", STEPS,
    ids=[f"{t}{'-amp' if a else ''}-{k}{'-lin' if li else ''}"
         f"{'-u8' if u else '-f32'}-x{f}" for t, a, k, li, u, f in STEPS])
def test_loss_and_gradients_match_jax(trunk, amp, kind, linear, u8, f):
    params = tree(f)
    hr = batch(f, u8)
    kw = dict(factor=f, batch_size=2, crop=hr.shape[1], trunk=trunk, amp=amp,
              loss_kind=kind, linear_loss=linear)
    loss, mse, grads = port_value_and_grad(params, hr, TL.TrainConfig(**kw))
    j_loss, j_mse, j_grads = jax_value_and_grad(params, hr,
                                                JL.TrainConfig(**kw))
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
    np.testing.assert_allclose(mse, j_mse, rtol=1e-5)
    assert list(grads) == list(params)
    bf16 = amp or trunk == "packed"
    if bf16:
        truth = float64_grads(params, hr, TL.TrainConfig(**kw))
        jax_truth = float64_grads(params, hr, TL.TrainConfig(**kw),
                                  jax_points=True)
    for k, g in grads.items():
        scale = float(np.abs(j_grads[k]).max())
        assert scale > 0, k
        if not bf16:
            np.testing.assert_allclose(g, j_grads[k], rtol=0,
                                       atol=1e-4 * scale, err_msg=k)
            continue
        t = truth[k]
        np.testing.assert_allclose(g, t, rtol=0,
                                   atol=1e-3 * float(np.abs(t).max()),
                                   err_msg=k)
        np.testing.assert_allclose(
            g, j_grads[k], rtol=0, err_msg=k,
            atol=2e-2 * scale + float(np.abs(j_grads[k] - jax_truth[k])
                                      .max()))


def float64_grads(params, hr, cfg, jax_points=False):
    """The bf16 tier's gradients with every sum in float64: the port's
    loss on float64 parameters and batch, its convolutions replaced by
    float64 ones of the same bf16-rounded operands, so only the rounding
    points remain.  The gradients pass through unrounded as
    `ops.conv.conv2d_bf16`'s do or, with ``jax_points``, are rounded to
    bf16 at each cast as the JAX package's are."""
    import torch.nn.functional as F
    from rusty_sr_tpu_torch.models import sr_net

    def conv64(h, w):
        k = w.shape[0]
        return F.conv2d(h.double().permute(0, 3, 1, 2),
                        w.double().permute(3, 2, 0, 1),
                        padding=k // 2).permute(0, 2, 3, 1)

    def conv64_bf16(h, w):
        if jax_points:      # a cast's gradient is rounded to bf16
            return conv64(h.to(torch.bfloat16), w.to(torch.bfloat16))

        def rounded(t):     # bf16 values forward, the gradient unrounded
            return t + (t.to(torch.bfloat16).to(t.dtype) - t).detach()
        return conv64(rounded(h), rounded(w))

    x = np.asarray(hr, np.float32)
    if hr.dtype == np.uint8:
        x = x * np.float32(1 / 255.0)
    p = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
         for k, v in params.items()}
    saved = sr_net.conv2d_same, sr_net.conv2d_bf16
    sr_net.conv2d_same, sr_net.conv2d_bf16 = conv64, conv64_bf16
    try:
        loss, _ = TL.loss_fn(p, torch.from_numpy(x).double(), cfg)
    finally:
        sr_net.conv2d_same, sr_net.conv2d_bf16 = saved
    grads = torch.autograd.grad(loss, list(p.values()))
    return {k: g.numpy() for k, g in zip(p, grads)}


def test_u8_batch_gives_the_f32_batch_loss():
    u8 = batch(3, u8=True)
    f32 = u8.astype(np.float32) * np.float32(1 / 255.0)
    cfg = TL.TrainConfig(batch_size=2, crop=24)
    a = port_value_and_grad(tree(3), u8, cfg)
    b = port_value_and_grad(tree(3), f32, cfg)
    # the same batch; two CPU convolutions need not agree bit for bit
    np.testing.assert_allclose(a[0], b[0], rtol=1e-6)
    for k in a[2]:
        np.testing.assert_allclose(a[2][k], b[2][k], rtol=0, atol=1e-6
                                   * float(np.abs(b[2][k]).max()), err_msg=k)


@pytest.mark.parametrize("trunk", ["merged", "packed"])
def test_remat_equals_no_remat(trunk):
    hr = batch(3, u8=True, seed=4)
    outs = [port_value_and_grad(tree(3), hr, TL.TrainConfig(
        batch_size=2, crop=24, trunk=trunk, remat=remat))
        for remat in (False, True)]
    assert abs(outs[0][0] - outs[1][0]) <= 1e-6 * abs(outs[0][0])
    for k in outs[0][2]:
        np.testing.assert_allclose(outs[1][2][k], outs[0][2][k], rtol=0,
                                   atol=1e-6 * float(np.abs(
                                       outs[0][2][k]).max()), err_msg=k)


def test_l2_term_is_half_coef_sum_of_squares():
    params = tree(3)
    hr = batch(3)
    l0 = port_value_and_grad(params, hr, TL.TrainConfig(crop=24, l2_reg=0.0))
    l1 = port_value_and_grad(params, hr, TL.TrainConfig(crop=24))
    w2 = sum(float(np.sum(np.asarray(v, np.float64) ** 2))
             for v in params.values())
    assert l1[0] - l0[0] == pytest.approx(0.5e-6 * w2, rel=1e-3)


def jax_steps(params, hrs, cfg, state=None):
    opt = JL.make_optimizer(cfg)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    st = opt.init(p) if state is None else state

    def step(p, st, hr):
        (_, _), g = jax.value_and_grad(JL.loss_fn, has_aux=True)(p, hr, cfg)
        up, st = opt.update(g, st, p)
        return optax.apply_updates(p, up), st
    for hr in hrs:
        p, st = step(p, st, jnp.asarray(hr))
    return {k: np.asarray(v) for k, v in p.items()}, st


def port_steps(params, hrs, cfg, state=None):
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = TL.make_optimizer(cfg, p)
    if state is not None:
        opt.load_state_dict(state)
    for hr in hrs:
        TL.train_step(p, opt, torch.from_numpy(hr), cfg)
    return {k: v.detach().numpy() for k, v in p.items()}


def test_three_adam_steps_match_optax():
    cfg_kw = dict(batch_size=2, crop=24)
    params = tree(3, seed=2)
    hrs = [batch(3, u8=True, seed=10 + i) for i in range(3)]
    want, _ = jax_steps(params, hrs, JL.TrainConfig(**cfg_kw))
    got = port_steps(params, hrs, TL.TrainConfig(**cfg_kw))
    moved = max(float(np.abs(want[k] - params[k]).max()) for k in params)
    assert moved > 1e-3          # Adam's first steps move by ~lr = 2e-3
    for k in params:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                   err_msg=k)


def test_adam_state_from_optax_continues_the_same():
    """JAX takes two steps; its Adam moments and count become the port's
    optimizer state (`adam_state_from_numpy`); the third step agrees."""
    cfg_kw = dict(batch_size=2, crop=24)
    params = tree(3, seed=3)
    hrs = [batch(3, u8=True, seed=20 + i) for i in range(3)]
    p2, st2 = jax_steps(params, hrs[:2], JL.TrainConfig(**cfg_kw))
    adam = st2[0]
    mu = {k: np.asarray(v) for k, v in adam.mu.items()}
    nu = {k: np.asarray(v) for k, v in adam.nu.items()}
    want, _ = jax_steps(p2, hrs[2:], JL.TrainConfig(**cfg_kw), state=st2)
    shell = {k: torch.tensor(v) for k, v in p2.items()}
    state = TL.adam_state_from_numpy(shell, mu, nu, np.asarray(adam.count),
                                     TL.TrainConfig(**cfg_kw))
    got = port_steps(p2, hrs[2:], TL.TrainConfig(**cfg_kw), state=state)
    for k in params:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    # a fresh Adam from p2 takes a different step
    fresh = port_steps(p2, hrs[2:], TL.TrainConfig(**cfg_kw))
    assert max(float(np.abs(fresh[k] - want[k]).max()) for k in params) \
        > 1e-4


def test_config_refusals():
    p = {k: torch.tensor(v) for k, v in tree(3).items()}
    hr = torch.from_numpy(batch(3))
    with pytest.raises(ValueError, match="trunk"):
        TL.loss_fn(p, hr, TL.TrainConfig(trunk="wide"))


def rounding_points_table(out=print):
    """For each bf16 case of STEPS, the largest over the leaves of |port -
    JAX| / JAX's max with the port's convolutions as they are and with
    their gradients rounded to bf16 at each cast (JAX's rounding points,
    the port's arithmetic before it kept them in float32); |JAX - float64
    at JAX's points| / JAX's max; |port - float64| / float64's max, at
    the port's points and at JAX's.  Run from the repo's root:
    ``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_train_step.py``.
    """
    from rusty_sr_tpu_torch.models import sr_net
    from rusty_sr_tpu_torch.ops.conv import conv2d_same
    bf = torch.bfloat16

    def at_jax_points(h, w):
        return conv2d_same(h.to(bf), w.to(bf))

    for trunk, amp, kind, linear, u8, f in STEPS:
        if not (amp or trunk == "packed"):
            continue
        params, hr = tree(f), batch(f, u8)
        kw = dict(factor=f, batch_size=2, crop=hr.shape[1], trunk=trunk,
                  amp=amp, loss_kind=kind, linear_loss=linear)
        cfg = TL.TrainConfig(**kw)
        g = port_value_and_grad(params, hr, cfg)[2]
        saved, sr_net.conv2d_bf16 = sr_net.conv2d_bf16, at_jax_points
        try:
            g_jp = port_value_and_grad(params, hr, cfg)[2]
        finally:
            sr_net.conv2d_bf16 = saved
        j = jax_value_and_grad(params, hr, JL.TrainConfig(**kw))[2]
        t, tj = (float64_grads(params, hr, cfg, jax_points=jp)
                 for jp in (False, True))

        def worst(a, b, by):
            return max(float(np.abs(a[k] - b[k]).max() / np.abs(by[k]).max())
                       for k in params)
        out(f"{trunk}{'-amp' if amp else ''}-{kind}-x{f}: port-JAX "
            f"{worst(g, j, j):.3e} (at JAX's points {worst(g_jp, j, j):.3e});"
            f" JAX-float64 at its points {worst(j, tj, j):.3e}; "
            f"port-float64 at its points {worst(g, t, t):.3e} (at JAX's "
            f"{worst(g, tj, tj):.3e})")


if __name__ == "__main__":
    rounding_points_table()
