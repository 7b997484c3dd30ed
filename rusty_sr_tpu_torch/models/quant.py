"""The int8 trunk: calibrated, asymmetric, per-channel quantisation.

The scheme of `rusty_sr_tpu/models/quant.py`, step for step:

- Each activation that feeds an int8 stage (f -> convA, l1 -> convB,
  l2 -> convC) is quantised per channel, asymmetrically, from calibrated
  ranges: ``xq = clip(round(x / s[c]) + z[c], -127, 127)`` with
  ``s = (hi - lo) / 254`` and ``z = round(-127 - lo / s)``.  The ranges
  include 0, so a zero-padded pixel quantises to exactly ``z``.
- The scales fold into the next conv's weights along the input channel;
  the folded weights quantise per output channel into an int8 main part
  and an int8 residual (two products over the same patches), and the
  zero points' contribution is a per-output constant subtracted after
  the products.
- conv0 and conv10 stay bf16 convolutions with f32 sums (on the
  conv-stage kernel, `ops.cuda.conv_stage`); the glue, the bilinear base
  and the final sum stay f32.

The int8 products run through `int8_mm`: on CUDA tensors
``torch._int_mm`` (int8 x int8 -> int32, cuBLASLt), the counterpart of
the JAX package's ``lax.dot_general`` with an int32 result; on CPU tensors
its plain version `int8_mm_reference`.  `LAUNCHES` counts the
``torch._int_mm`` calls.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rusty_sr_tpu_torch.ops.activations import belu
from rusty_sr_tpu_torch.ops.conv import conv2d_same, exact_f32, im2col_patches
from rusty_sr_tpu_torch.ops.cuda.conv_stage import (Epilogue, FusedStage,
                                                    conv_stage, prepare_stage)
from rusty_sr_tpu_torch.ops.pixel_shuffle import depth_to_space
from rusty_sr_tpu_torch.ops.resize import bilinear_phases

# int8 stages: activation name -> merged conv consuming it
_Q_STAGES = (("f", "convA"), ("l1", "convB"), ("l2", "convC"))

# Launches of torch._int_mm since the count was last set to 0.
LAUNCHES = 0


def int8_mm_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version of `int8_mm`: the int32 product of two int8
    matrices in integers — int32 arithmetic on the CPU; elsewhere float64,
    which holds every partial sum exactly (|sum| <= K * 127^2 < 2^53)."""
    if a.device.type == "cpu":
        return a.to(torch.int32) @ b.to(torch.int32)
    return (a.double() @ b.double()).to(torch.int32)


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32.  CPU tensors take
    `int8_mm_reference`; CUDA tensors ``torch._int_mm`` (M > 16, K and N
    multiples of 8); any other device raises."""
    global LAUNCHES
    if a.device.type == "cpu":
        return int8_mm_reference(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"int8_mm runs on cpu or cuda, not {a.device}")
    out = torch._int_mm(a, b)
    LAUNCHES += 1
    return out


def _act_minmax(mparams, x: torch.Tensor) -> dict:
    """Per-channel (min, max) of the trunk activations f, l1, l2 on the
    sample ``x`` through the exact f32 forward, each range made to
    include 0."""
    p = mparams
    n = p["f_bias"].shape[0]
    with torch.no_grad():
        f = belu(conv2d_same(x, p["conv0"]) + p["f_bias"], p["f_belu"])
        a = conv2d_same(f, p["convA"])
        l1 = belu(a[..., :n] + p["l1_bias"], p["l1_belu"])
        b = conv2d_same(l1, p["convB"])
        l2 = belu(a[..., n:2 * n] + b[..., :n] + p["l2_bias"], p["l2_belu"])

    def rng(t):
        return (torch.clamp(t.amin(dim=(0, 1, 2)), max=0.0),
                torch.clamp(t.amax(dim=(0, 1, 2)), min=0.0))
    return {"f": rng(f), "l1": rng(l1), "l2": rng(l2)}


def calibrate_act_scales(mparams, sample_x, margin: float = 0.05,
                         microbatch: int = 4) -> dict:
    """Per-channel int8 activation ranges from a sample: {stage: (lo, hi)}.

    ``mparams``: the merged tree (`models.sr_net.merge_params`) as float32
    tensors; ``sample_x``: (N, H, W, 3) float32 sRGB on their device.  The
    sample runs through the exact f32 forward in ``microbatch`` slices,
    padded with repeated tiles (min and max do not change), with the
    ranges folded across slices, and each range is widened by ``1 +
    margin``."""
    x = torch.as_tensor(sample_x, dtype=torch.float32)
    pad = (-x.shape[0]) % microbatch
    if pad:
        x = torch.cat([x, x[torch.arange(pad) % x.shape[0]]])
    mm: dict = {}
    with exact_f32():
        for i in range(0, x.shape[0], microbatch):
            for k, (lo, hi) in _act_minmax(mparams,
                                           x[i:i + microbatch]).items():
                mm[k] = (torch.minimum(mm[k][0], lo),
                         torch.maximum(mm[k][1], hi)) if k in mm else (lo, hi)
    g = 1.0 + margin
    return {k: (lo * g, hi * g) for k, (lo, hi) in mm.items()}


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def quantize_trunk(mparams, act_ranges: dict) -> dict:
    """The merged tree and calibrated ranges -> the int8 trunk's tree, with
    the JAX package's keys (``<conv>_q1``/``_q2`` int8 HWIO, ``_s1``/``_s2``
    per-output scales, ``_zc`` the zero-point constant; ``<act>_invs``,
    ``<act>_z``; ``conv0``/``conv10`` in bf16; the vectors in f32), and
    the products' operands: ``<conv>_m1``/``_m2``, the int8 weights as a
    (K, N) matrix in the patch order of `ops.conv.im2col_patches`, K over
    the input channels padded to a multiple of 8 and N padded to one (the
    shapes ``torch._int_mm`` takes; the padding is zero), stored
    column-major; ``conv0_pad``, conv0 with its 3 input channels padded
    to 8 for the conv-stage kernel."""
    bf = torch.bfloat16
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32)  # noqa: E731
    q = {"conv0": f32(mparams["conv0"]).to(bf),
         "conv10": f32(mparams["conv10"]).to(bf)}
    c0 = q["conv0"]
    q["conv0_pad"] = F.pad(c0, (0, 0, 0, _pad8(c0.shape[2]) - c0.shape[2]))
    for act, conv in _Q_STAGES:
        lo, hi = (f32(t) for t in act_ranges[act])
        s = torch.clamp((hi - lo) / 254.0, min=1e-7)            # (Cin,)
        z = torch.round(-127.0 - lo / s)                        # x=0 -> z
        w = f32(mparams[conv]) * s[None, None, :, None]
        sw1 = torch.clamp(w.abs().amax(dim=(0, 1, 2)), min=1e-12) / 127.0
        wq1 = torch.round(w / sw1).to(torch.int8)
        r = w - wq1.float() * sw1                               # residual
        sw2 = torch.clamp(r.abs().amax(dim=(0, 1, 2)), min=1e-20) / 127.0
        wq2 = torch.round(r / sw2).to(torch.int8)
        q[conv + "_q1"], q[conv + "_s1"] = wq1, sw1
        q[conv + "_q2"], q[conv + "_s2"] = wq2, sw2
        q[act + "_invs"], q[act + "_z"] = 1.0 / s, z
        # zero-point correction: sum_{c,k} Wq[c,k,o]*sw[o]*z[c], a
        # per-output constant, summed in f32 one tap row after another (the
        # order of the JAX package's reduction on the CPU)
        terms = ((wq1.float() * sw1 + wq2.float() * sw2)
                 * z[None, None, :, None]).reshape(-1, w.shape[3]).cpu()
        zc = torch.zeros_like(terms[0])
        for row in terms:
            zc = zc + row
        q[conv + "_zc"] = zc.to(w.device)
        kh, kw, cin, cout = wq1.shape
        for i, wq in (("1", wq1), ("2", wq2)):
            m = F.pad(wq, (0, _pad8(cout) - cout, 0, _pad8(cin) - cin))
            q[conv + "_m" + i] = m.reshape(-1, m.shape[3]).t().contiguous().t()
    for name in ("f_bias", "f_belu", "l1_bias", "l1_belu", "l2_bias",
                 "l2_belu", "l3_bias", "l3_belu", "expand_bias"):
        q[name] = f32(mparams[name])
    return q


def prepare_q8(q: dict) -> dict:
    """``q`` with conv0's and conv10's weights packed once for the
    conv-stage kernel (`prepare_stage`), on their device."""
    return {**q, "conv0_pad": prepare_stage(q["conv0_pad"]),
            "conv10": prepare_stage(q["conv10"])}


def _conv_q8(x: torch.Tensor, q: dict, act: str, conv: str) -> torch.Tensor:
    """Asymmetric int8 Same conv of f32 ``x``: pad -> quantise -> im2col ->
    two int32 products (main and residual weights) -> dequantised f32,
    the zero points' constant subtracted."""
    kh, kw, cin, cout = q[conv + "_q1"].shape
    xp = F.pad(x, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    xq = torch.clamp(torch.round(xp * q[act + "_invs"]) + q[act + "_z"],
                     -127, 127).to(torch.int8)
    if cin % 8:
        xq = F.pad(xq, (0, _pad8(cin) - cin))
    pat = im2col_patches(xq, kh, kw)
    lead = pat.shape[:3]
    pat = pat.reshape(-1, pat.shape[3])

    def dot(i):
        return int8_mm(pat, q[conv + "_m" + i])[:, :cout].float()

    y = dot("1") * q[conv + "_s1"] + dot("2") * q[conv + "_s2"] \
        - q[conv + "_zc"]
    return y.reshape(*lead, cout)


def q8_expand(q: dict, x: torch.Tensor, factor: int,
              mask: torch.Tensor | None = None) -> torch.Tensor:
    """The int8 trunk: (N, H, W, 3) f32 -> the LR-space residual phases
    (N, H, W, 3 f^2) f32.  ``mask`` ((N, H, W, 1) {0,1}, optional) zeroes
    every activation outside the image, as the tile kernels need; masked
    zeros quantise to exactly the zero point.  conv0 runs on the
    conv-stage kernel with its bias, BeLU and mask fused (f32 out),
    conv10 on it unfused."""
    bf = torch.bfloat16
    e = x.shape[-1] * factor * factor
    n = q["f_bias"].shape[0]
    mb = None if mask is None else mask.to(bf)

    def msk(t):
        return t if mask is None else mask * t

    w0 = q["conv0_pad"]
    cin0 = getattr(w0, "hwio", w0).shape[2]
    x0 = F.pad(x.to(bf), (0, cin0 - x.shape[-1]))
    f = conv_stage(x0, FusedStage(w0, Epilogue(
        n, q["f_bias"], q["f_belu"], (), mb, act_dtype=torch.float32)),
        torch.float32)
    a = _conv_q8(f, q, "f", "convA")
    l1 = msk(belu(a[..., :n] + q["l1_bias"], q["l1_belu"]))
    b = _conv_q8(l1, q, "l1", "convB")
    l2 = msk(belu(a[..., n:2 * n] + b[..., :n] + q["l2_bias"], q["l2_belu"]))
    c = _conv_q8(l2, q, "l2", "convC")
    l3 = msk(belu(a[..., 2 * n:3 * n] + b[..., n:2 * n] + c[..., :n]
                  + q["l3_bias"], q["l3_belu"]))
    d = conv_stage(l3.to(bf), q["conv10"], torch.float32)
    return b[..., 2 * n:2 * n + e] + c[..., n:n + e] + d + q["expand_bias"]


def sr_apply_q8(q: dict, x: torch.Tensor, factor: int = 3) -> torch.Tensor:
    """The int8-trunk SR forward: (N, H, W, 3) f32 -> (N, fH, fW, 3) f32."""
    expand = q8_expand(q, x, factor)
    return depth_to_space(bilinear_phases(x, factor) + expand, factor)
