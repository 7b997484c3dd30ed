"""The SR network as plain PyTorch, and its training forms.

Topology (the reference's `sr_net`; `rusty_sr_tpu/models/sr_net.py`):

    base   = LinearInterp_f(input)                      # sRGB-domain bilinear
    f      = BeLU(conv0_5x5(input) + f_bias)
    l1     = BeLU(conv1_5x5(f) + l1_bias)
    l2     = BeLU(conv2_5x5(f) + conv5_3x3(l1) + l2_bias)
    l3     = BeLU(conv3_5x5(f) + conv6_3x3(l1) + conv8_3x3(l2) + l3_bias)
    expand = conv7_3x3(l1) + conv9_3x3(l2) + conv10_3x3(l3) + expand_bias
    output = base + depth_to_space_f(expand)

Parameters are a dict of HWIO float32 tensors (`params.to_torch`), or
the `SRNet` module that holds them as `nn.Parameter`s under the same
names.  Every function here is differentiable with respect to them: the
weight merging (`merge_params`, a concatenation) and the space-to-depth
packing (`parallel.tiling.s2d_conv_weights`, a selection product) run
inside the forward pass, so gradients reach the 19 reference tensors.

``compute_dtype=torch.bfloat16`` rounds each convolution's operands to
bfloat16 and sums in float32 (`ops.conv.conv2d_bf16`), as the JAX
package's mixed-precision forms do; the parameters, the bias and BeLU
arithmetic and the residual sum stay float32.  Its gradients come back
unrounded: a training step rounds each weight's to bfloat16 once
(`train.loop.bf16_grad_leaves`), after a mesh's all-reduce.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from rusty_sr_tpu_torch.ops.activations import belu
from rusty_sr_tpu_torch.ops.color import linear_to_srgb, srgb_to_linear
from rusty_sr_tpu_torch.ops.conv import (conv2d_bf16, conv2d_bf16x3,
                                        conv2d_same, conv_split_precise)
from rusty_sr_tpu_torch.ops.pixel_shuffle import depth_to_space
from rusty_sr_tpu_torch.ops.resize import (avg_pool, bilinear_phases,
                                           upsample_bilinear)


def sr_apply(params, x: torch.Tensor, factor: int = 3, *, compute_dtype=None,
             conv_fn=None) -> torch.Tensor:
    """SR forward pass. x: (N,H,W,3) sRGB f32 in [0,1] -> (N,fH,fW,3).

    ``compute_dtype`` optionally runs the convolutions on bf16 operands
    (float32 sums, `conv2d_bf16`); ``conv_fn(h, w)`` replaces
    `conv2d_same` (on the operands cast to ``compute_dtype``)."""
    p = params
    base = upsample_bilinear(x, factor)
    _conv = conv_fn or conv2d_same

    def cv(h, name):
        w = p[name]
        if compute_dtype is not None:
            if conv_fn is None and compute_dtype == torch.bfloat16:
                return conv2d_bf16(h, w)
            w, h = w.to(compute_dtype), h.to(compute_dtype)
        return _conv(h, w)

    f = belu(cv(x, "conv0") + p["f_bias"], p["f_belu"])
    l1 = belu(cv(f, "conv1") + p["l1_bias"], p["l1_belu"])
    l2 = belu(cv(f, "conv2") + cv(l1, "conv5") + p["l2_bias"], p["l2_belu"])
    l3 = belu(cv(f, "conv3") + cv(l1, "conv6") + cv(l2, "conv8")
              + p["l3_bias"], p["l3_belu"])
    expand = (cv(l1, "conv7") + cv(l2, "conv9") + cv(l3, "conv10")
              + p["expand_bias"])
    return base + depth_to_space(expand, factor).to(base.dtype)


def merge_params(params) -> dict:
    """Concatenate same-source conv weights along O: conv1|2|3 -> convA,
    conv5|6|7 -> convB, conv8|9 -> convC.  Convolution is linear in the
    kernel, so the merged tree computes the same values with three wide
    convolutions in place of eight narrow ones; the concatenation's
    gradient is a slice, so gradients reach the eight narrow tensors."""
    def cat(*names):
        return torch.cat([torch.as_tensor(params[k]) for k in names], dim=3)

    m = {k: v for k, v in params.items()
         if k not in ("conv1", "conv2", "conv3", "conv5", "conv6", "conv7",
                      "conv8", "conv9")}
    m["convA"] = cat("conv1", "conv2", "conv3")
    m["convB"] = cat("conv5", "conv6", "conv7")
    m["convC"] = cat("conv8", "conv9")
    return m


def sr_apply_fused(mparams, x: torch.Tensor, factor: int = 3, *,
                   compute_dtype=None, conv_fn=None,
                   round_output: bool = True,
                   conv0_split: bool = True) -> torch.Tensor:
    """`sr_apply` over `merge_params` output — identical math, three wide
    convolutions, the bilinear base added in LR space as phase images.

    ``round_output=False`` keeps the output float32 under
    ``compute_dtype`` (training: an unquantised loss surface).
    ``conv0_split`` reads conv0's input through the three-term bf16 split
    (`ops.conv.conv_split_precise`) under ``compute_dtype``; False casts
    it once, as `sr_apply` does (the training form)."""
    p = mparams
    e = x.shape[-1] * factor * factor
    _conv = conv_fn or conv2d_same

    def cv(h, name, native=False):
        w = p[name]
        if compute_dtype is not None:
            if native and conv_fn is None and conv0_split:
                return conv_split_precise(h, w)
            if conv_fn is None and compute_dtype == torch.bfloat16:
                return conv2d_bf16(h, w)
            w, h = w.to(compute_dtype), h.to(compute_dtype)
        return _conv(h, w)

    n = p["f_bias"].shape[0]
    f = belu(cv(x, "conv0", native=True) + p["f_bias"], p["f_belu"])
    a = cv(f, "convA")                                   # (..., 3n)
    l1 = belu(a[..., :n] + p["l1_bias"], p["l1_belu"])
    b = cv(l1, "convB")                                  # (..., 2n+e)
    l2 = belu(a[..., n:2 * n] + b[..., :n] + p["l2_bias"], p["l2_belu"])
    c = cv(l2, "convC")                                  # (..., n+e)
    l3 = belu(a[..., 2 * n:3 * n] + b[..., n:2 * n] + c[..., :n]
              + p["l3_bias"], p["l3_belu"])
    expand = (b[..., 2 * n:2 * n + e] + c[..., n:n + e] + cv(l3, "conv10")
              + p["expand_bias"])
    base_ph = bilinear_phases(x, factor)
    total = base_ph + expand.to(base_ph.dtype)
    if compute_dtype is not None and round_output:
        total = total.to(compute_dtype)
    return depth_to_space(total, factor)


def sr_apply_packed(mparams, x: torch.Tensor, factor: int = 3, *,
                    compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The training form of the fast tier's packed trunk: the whole net at
    quarter resolution and four times the channels (2x2 space-to-depth),
    with the weights packed inside the forward pass
    (`parallel.tiling.s2d_conv_weights`) so gradients reach the 19
    reference tensors.  Even H and W only.  Zero Same padding in packed
    space is zero padding in the original space for even sides, so no
    mask or halo is needed."""
    from rusty_sr_tpu_torch.parallel.tiling import s2d_conv_weights

    cd = compute_dtype
    p = mparams
    n = p["f_bias"].shape[0]
    e = p["expand_bias"].shape[0]
    N, H, W, C = x.shape
    xp = x.reshape(N, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5) \
        .reshape(N, H // 2, W // 2, 4 * C)

    def cv(t, w):
        return conv2d_bf16(t, w) if cd == torch.bfloat16 else \
            conv2d_same(t.to(cd), w.to(cd))

    def tl(v):
        return v.repeat(4)

    f_ = belu(cv(xp, s2d_conv_weights(p["conv0"], [n])) + tl(p["f_bias"]),
              tl(p["f_belu"]))
    a = cv(f_, s2d_conv_weights(p["convA"], [n, n, n]))
    Nn = 4 * n
    l1 = belu(a[..., :Nn] + tl(p["l1_bias"]), tl(p["l1_belu"]))
    b = cv(l1, s2d_conv_weights(p["convB"], [n, n, e]))
    l2 = belu(a[..., Nn:2 * Nn] + b[..., :Nn] + tl(p["l2_bias"]),
              tl(p["l2_belu"]))
    c = cv(l2, s2d_conv_weights(p["convC"], [n, e]))
    l3 = belu(a[..., 2 * Nn:3 * Nn] + b[..., Nn:2 * Nn] + c[..., :Nn]
              + tl(p["l3_bias"]), tl(p["l3_belu"]))
    d = cv(l3, s2d_conv_weights(p["conv10"], [e]))
    total = (b[..., 2 * Nn:2 * Nn + 4 * e] + c[..., Nn:Nn + 4 * e] + d
             + tl(p["expand_bias"]))
    expand = total.reshape(N, H // 2, W // 2, 2, 2, e) \
        .permute(0, 1, 3, 2, 4, 5).reshape(N, H, W, e)
    base_ph = bilinear_phases(x, factor)
    return depth_to_space(base_ph + expand.to(base_ph.dtype), factor)


def bilinear_apply(x: torch.Tensor, factor: int = 3) -> torch.Tensor:
    """`-p bilinear`: sRGB->linear -> bilinear xf -> linear->sRGB."""
    return linear_to_srgb(upsample_bilinear(srgb_to_linear(x), factor))


def downsample_apply(x: torch.Tensor, factor: int = 3) -> torch.Tensor:
    """`--downsample`: sRGB->linear -> fxf mean pool -> linear->sRGB."""
    return linear_to_srgb(avg_pool(srgb_to_linear(x), factor))


def make_lr_from_hr(hr: torch.Tensor, factor: int = 3) -> torch.Tensor:
    """The training step's pair synthesis: the math of `downsample_apply`."""
    return downsample_apply(hr, factor)


TRUNKS = ("merged", "flat", "packed")


PRECISIONS = ("highest", "high")


def forward_fn(trunk: str = "merged", amp: bool = False,
               precision: str = "highest"):
    """The training forward ``fn(params, lr, factor) -> sr`` of a trunk:
    "merged" (`sr_apply_fused` over `merge_params`, merged inside the
    step, float32 out), "flat" (`sr_apply`, the literal topology) or
    "packed" (`sr_apply_packed`, bf16 operands whatever ``amp``);
    ``amp`` runs the first two on bf16 operands.  Their float32
    convolutions are exact for ``precision`` "highest" and the three-term
    bf16 split for "high" (`ops.conv.conv2d_bf16x3`, the JAX package's
    ``Precision.HIGH``), which ``amp`` and the packed trunk ignore, as
    there."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    cd = torch.bfloat16 if amp else None
    conv_fn = conv2d_bf16x3 if precision == "high" and not amp else None
    if trunk == "packed":
        return lambda p, x, f: sr_apply_packed(merge_params(p), x, f)
    if trunk == "merged":
        return lambda p, x, f: sr_apply_fused(
            merge_params(p), x, f, compute_dtype=cd, conv_fn=conv_fn,
            round_output=False, conv0_split=False)
    if trunk == "flat":
        return lambda p, x, f: sr_apply(p, x, f, compute_dtype=cd,
                                        conv_fn=conv_fn)
    raise ValueError(f"trunk must be one of {TRUNKS}, got {trunk!r}")


class SRNet(nn.Module):
    """The network as a module: the 19 reference tensors as parameters
    under their reference names (HWIO convolutions), so `torch.optim`
    works on it directly; ``forward(lr)`` runs the training forward of
    ``trunk`` at ``precision`` (`forward_fn`).  It is built from a
    parameter tree of `params.py` (numpy or tensors) and gives one back
    with `tree`."""

    def __init__(self, tree, factor: int = 3, trunk: str = "merged",
                 amp: bool = False, precision: str = "highest"):
        super().__init__()
        self.factor = factor
        self.trunk = trunk
        self.amp = amp
        self._fwd = forward_fn(trunk, amp, precision)
        for k, v in tree.items():
            self.register_parameter(k, nn.Parameter(torch.as_tensor(
                np.asarray(v, np.float32)).clone()))

    def params(self) -> dict:
        """name -> parameter, in the tree's order."""
        return dict(self.named_parameters())

    def tree(self) -> dict:
        """name -> float32 numpy copy (the tree of `params.py`)."""
        return {k: v.detach().cpu().numpy().copy()
                for k, v in self.named_parameters()}

    def forward(self, lr: torch.Tensor) -> torch.Tensor:
        return self._fwd(self.params(), lr, self.factor)
