"""The training forms of the network against the JAX package's.

Inputs are made from a seed with numpy and go through both packages.
Tolerances:
- float32 forms: atol 3e-6 (the JAX suite's exact-tier bound) and at
  most 1 u8 code once quantised (values within 3e-6 can still round to
  neighbouring codes);
- bf16 forms (one rounding of each convolution's operands, float32 sums
  in another order): at least 45 dB and at most 8 u8 codes, the JAX
  suite's bf16 class (tests/test_tiling.py);
- `conv_split_precise`: its forward value and weight gradient to
  float32 noise (1e-5 of the largest value); its input gradient within
  0.5 bf16 ulp (plus f32 noise) of the float64 gradient (see the test
  for why not JAX's).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rusty_sr_tpu.models import sr_net as J
from rusty_sr_tpu.ops.conv import conv_split_precise as j_split
from rusty_sr_tpu_torch.models import sr_net as T
from rusty_sr_tpu_torch.ops.conv import conv_split_precise
from rusty_sr_tpu_torch.params import (init_params, load_builtin,
                                       load_rsr_file, to_torch)
from rusty_sr_tpu_torch.utils.imageio import psnr, to_u8

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
ATOL = 3e-6
BF = torch.bfloat16


def weights(name):
    """(tree, factor): the anime weights, the factor-2/4 fixtures, or a
    width-8 init at factors 2, 3 and 4."""
    if name == "anime":
        return load_builtin("anime"), 3
    if name.startswith("fixture"):
        f = int(name[-1])
        return load_rsr_file(os.path.join(FIXTURES, f"factor{f}.rsr"), f), f
    f = int(name[-1])
    return init_params(f, f, width=8), f


WEIGHTS = ["anime", "fixture2", "fixture4", "w8-f2", "w8-f3", "w8-f4"]


def image(shape, seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def jx(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def codes(a, b):
    return int(np.abs(to_u8(a).astype(int) - to_u8(b).astype(int)).max())


def check_f32(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert codes(got, want) <= 1


def check_bf16(got, want):
    assert got.shape == want.shape
    assert psnr(np.clip(got, 0, 1), np.clip(want, 0, 1)) >= 45.0
    assert codes(got, want) <= 8


@pytest.mark.parametrize("name", WEIGHTS)
@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
def test_sr_apply_matches_jax(name, amp):
    tree, f = weights(name)
    x = image((2, 10, 12, 3), 1)
    cd = BF if amp else None
    got = T.sr_apply(to_torch(tree, "cpu"), torch.from_numpy(x), f,
                     compute_dtype=cd).numpy()
    want = np.asarray(J.sr_apply(jx(tree), jnp.asarray(x), f,
                                 compute_dtype=jnp.bfloat16 if amp else None))
    (check_bf16 if amp else check_f32)(got, want)


FUSED = [(None, True, True), (BF, True, True), (BF, True, False),
         (BF, False, True), (BF, False, False)]


@pytest.mark.parametrize("name", ["anime", "w8-f2", "fixture4"])
@pytest.mark.parametrize("cd,split,rnd", FUSED,
                         ids=["f32", "bf16-split-round", "bf16-split",
                              "bf16-round", "bf16"])
def test_sr_apply_fused_matches_jax(name, cd, split, rnd):
    tree, f = weights(name)
    x = image((2, 9, 11, 3), 2)
    got = T.sr_apply_fused(T.merge_params(to_torch(tree, "cpu")),
                           torch.from_numpy(x), f, compute_dtype=cd,
                           round_output=rnd, conv0_split=split)
    want = np.asarray(J.sr_apply_fused(
        J.merge_params(jx(tree)), jnp.asarray(x), f,
        compute_dtype=None if cd is None else jnp.bfloat16,
        round_output=rnd, conv0_split=split).astype(jnp.float32))
    (check_f32 if cd is None else check_bf16)(got.float().numpy(), want)


@pytest.mark.parametrize("name", ["anime", "w8-f2", "w8-f4"])
def test_sr_apply_packed_matches_jax(name):
    tree, f = weights(name)
    x = image((2, 12, 10, 3), 3)
    got = T.sr_apply_packed(T.merge_params(to_torch(tree, "cpu")),
                            torch.from_numpy(x), f).numpy()
    want = np.asarray(J.sr_apply_packed(J.merge_params(jx(tree)),
                                        jnp.asarray(x), f))
    check_bf16(got, want)
    # and in the bf16 class of the float32 network
    check_bf16(got, T.sr_apply(to_torch(tree, "cpu"), torch.from_numpy(x),
                               f).numpy())


@pytest.mark.parametrize("fn", ["bilinear_apply", "downsample_apply",
                                "make_lr_from_hr"])
@pytest.mark.parametrize("f", [2, 3, 4])
def test_simple_forms_match_jax(fn, f):
    x = image((2, 12 * f, 7 * f, 3), 4 + f)
    got = getattr(T, fn)(torch.from_numpy(x), f).numpy()
    want = np.asarray(getattr(J, fn)(jnp.asarray(x), f))
    check_f32(got, want)


def bf16_ulps(got, truth):
    """|got - truth| in bf16 ulps of ``truth``."""
    t = np.asarray(truth, np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(t), 1e-30))) - 7)
    return np.abs(np.asarray(got, np.float64) - t) / ulp


def test_conv_split_precise_forward_and_gradient_match_jax():
    """The forward value and the weight gradient to float32 noise.  The
    input gradient is the plain bf16 conv's: the port rounds its float32
    sum once to bf16 (within 0.5 ulp of the float64 gradient), where the
    JAX op's im2col transpose sums the 25 taps' bf16 gradients in bf16
    (tens of ulps on values that cancel; measured 5.4e-3 of the largest
    value apart), so that one is held to float64 truth and to 1e-2 of
    the largest value against JAX."""
    r = np.random.default_rng(5)
    h = r.random((2, 9, 10, 3), dtype=np.float32)
    w = (r.standard_normal((5, 5, 3, 8)) * 0.2).astype(np.float32)
    g = r.standard_normal((2, 9, 10, 8)).astype(np.float32)
    want, vjp = jax.vjp(j_split, jnp.asarray(h), jnp.asarray(w))
    gh_want, gw_want = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    ht = torch.from_numpy(h).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    got = conv_split_precise(ht, wt)
    gh, gw = torch.autograd.grad(got, (ht, wt), torch.from_numpy(g))
    for a, b in ((got.detach().numpy(), np.asarray(want)),
                 (gw.numpy(), gw_want)):
        assert a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-5 * float(np.abs(b).max()))
    hb = torch.from_numpy(h).to(BF).double().requires_grad_(True)
    wb = torch.from_numpy(w).to(BF).double()
    y = torch.nn.functional.conv2d(hb.permute(0, 3, 1, 2),
                                   wb.permute(3, 2, 0, 1), padding=2)
    (truth,) = torch.autograd.grad(y.permute(0, 2, 3, 1), hb,
                                   torch.from_numpy(g).double())
    assert gh.dtype == torch.float32
    # correctly rounded: half an ulp, plus the f32 sum's own error
    # (~1e-6 relative, under 1e-3 ulp) where a value sits on a midpoint
    assert bf16_ulps(gh.numpy(), truth.numpy()).max() <= 0.501
    np.testing.assert_allclose(gh.numpy(), gh_want, rtol=0,
                               atol=1e-2 * float(np.abs(gh_want).max()))
    # the split is closer to the float32 conv than one bf16 rounding is
    exact = T.conv2d_same(ht.detach(), wt.detach())
    one = T.conv2d_same(ht.detach().to(BF), wt.detach().to(BF))
    assert float((got.detach() - exact).abs().max()) < \
        0.1 * float((one - exact).abs().max())


@pytest.mark.parametrize("trunk", ["merged", "flat", "packed"])
def test_srnet_module_round_trip(trunk):
    tree, f = weights("w8-f3")
    net = T.SRNet(tree, f, trunk=trunk)
    assert [k for k, _ in net.named_parameters()] == list(tree)
    assert sum(p.numel() for p in net.parameters()) == 13051
    back = net.tree()
    for k in tree:
        assert back[k].tobytes() == np.asarray(tree[k], np.float32).tobytes()
    x = torch.from_numpy(image((1, 8, 10, 3), 6))
    fwd = T.forward_fn(trunk)(to_torch(tree, "cpu"), x, f)
    torch.testing.assert_close(net(x), fwd, rtol=0, atol=1e-6)
    opt = torch.optim.SGD(net.parameters(), lr=0.1)
    net(x).sum().backward()
    opt.step()
    assert all(p.grad is not None and float(p.grad.abs().max()) > 0
               for p in net.parameters())
    with pytest.raises(ValueError, match="trunk"):
        T.forward_fn("wide")


def test_bf16_conv_is_exact_products_f32_sums():
    """bf16 operands: float32 out, the float32 convolution of the rounded
    operands; mixed operand types are refused."""
    r = np.random.default_rng(7)
    x = torch.from_numpy(r.random((1, 6, 7, 4), dtype=np.float32))
    w = torch.from_numpy(r.standard_normal((3, 3, 4, 5)).astype(np.float32))
    got = T.conv2d_same(x.to(BF), w.to(BF))
    assert got.dtype == torch.float32
    want = T.conv2d_same(x.to(BF).float(), w.to(BF).float())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="operands of one type"):
        T.conv2d_same(x.to(BF), w)
