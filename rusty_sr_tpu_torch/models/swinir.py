"""SwinIR for classical super-resolution (Liang et al., "SwinIR: Image
Restoration Using Swin Transformer", ICCVW 2021, arXiv:2108.10257), as
`models/network_swinir.py` of https://github.com/JingyunLiang/SwinIR
defines it with ``upsampler='pixelshuffle'`` and ``resi_connection=
'1conv'``, on parameter trees in its own state-dict layout, so that a
released ``.pth`` (``001_classicalSR_DF2K_s64w8_SwinIR-M_x4.pth``) loads
as it is.

On (frames, H, W, 3) images in [0, 1] (u8 pixels / 255):

    x0 = reflect-pad(x - mean) at bottom and right to multiples of the window
    f  = conv_first(x0);  t = LN(flatten(f))
    6 residual groups: r = t; their blocks (shift 0, then window / 2, ...):
        u = t + proj(WMSA_s(qkv(LN1(t))));  t = u + fc2(GELU(fc1(LN2(u))))
      t = flatten(conv(unflatten(t))) + r
    b  = conv_after_body(unflatten(LN(t))) + f
    y  = conv_last(upsample(LReLU(conv_before_upsample(b))))
    out = (y + mean)[:, :s*H, :s*W]

The widths (embedding, heads, window, MLP, groups and blocks, upsampler
features, scale) are read from the tree (`config_of`); ``img_range`` and
``mean`` are the classical-SR model's.  Activations are token-major
(frames, P*Q, C) through the transformer and NCHW in channels-last memory
for the convolutions, so that neither side copies to reach the other.

Two tiers (`prepare`, `forward`):
- fast (``fast=True``): GEMM and convolution operands bf16 with f32 sums
  (conv_last's bf16 operands summed in f32 through cuDNN's TF32 path,
  which holds them exactly, so the output is not rounded to bf16); the
  residual stream, LayerNorm statistics and softmax in f32; the window
  attention on the fused kernel (`ops.cuda.window_attn`, its plain
  version on the CPU), with the relative-position bias gathered once per
  block at `prepare` into (heads, 64, 64); each residual add fused with
  the LayerNorm (or the bf16 cast) that reads its sum
  (`ops.cuda.add_layernorm`: 2 * blocks + groups + 2 launches a chunk,
  80 for SwinIR-M), the stream updated in place; the MLP (fc1, erf GELU,
  fc2) one kernel a block (`ops.cuda.swin_mlp`, its plain version on the
  CPU; 36 launches a chunk for SwinIR-M), the hidden activation rounded
  once to bf16 and kept on the chip, its weights laid out at `prepare`;
  qkv and proj remain ``F.linear``;
- exact: float32 throughout with TF32 off (`ops.conv.exact_f32`), the
  window attention as plain torch operations (`window_attn_reference`),
  the MLP as ``F.linear``, ``F.gelu``, ``F.linear``.

Each stage is a `span`: ``swinir.embed`` (conv_first, the patch
embedding's LayerNorm and the first block's norm1), ``swinir.rstb`` (one
residual group, through the norm that reads its sum: the next group's
first norm1, or the final LayerNorm) and ``swinir.upsample``
(conv_after_body, the upsampler and conv_last through the output's u8
quantisation); ``swinir.norm_plain``
opens around each add-and-normalise of the exact tier, which takes the
plain version (the fast tier always calls `ops.cuda.add_layernorm`).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from rusty_sr_tpu_torch.ops.conv import exact_f32, tf32_on_bf16
from rusty_sr_tpu_torch.ops.cuda import add_layernorm, swin_mlp
from rusty_sr_tpu_torch.ops.cuda.window_attn import (relative_bias,
                                                     window_attn,
                                                     window_attn_reference)
from rusty_sr_tpu_torch.ops.pixel_shuffle import depth_to_space
from rusty_sr_tpu_torch.utils.profiling import span

NAME = "SwinIR"
# The classical-SR models' RGB mean (DIV2K) and image range.
MEAN = (0.4488, 0.4371, 0.4040)
IMG_RANGE = 1.0
LN_EPS = 1e-5

# The chunk loop's rules for this network (`parallel.tiling`): a frame is
# one tile, reflect-padded to whole windows, with no halo, since windows
# sit on the frame's own grid, the shift mask depends on where the frame
# ends, and 36 shifted blocks see across the whole frame.
HALO = 0
# Frames a chunk unless the caller says: one.  A 960x540 frame (522,240
# tokens) already fills the card; on an H100 16-frame calls took the same
# time at 1, 2, 4 and 8 frames a chunk (4.19-4.22 s), while the peak
# memory grew with the chunk (3.7, 7.4, 14.7, 28.8 GB).
DEFAULT_CHUNK = 1

_BLOCK = "layers.{}.residual_group.blocks.{}."


def unwrap(tree) -> dict:
    """The state dict inside a checkpoint: its ``params_ema`` or
    ``params`` entry where it has one, else the tree itself."""
    for key in ("params_ema", "params"):
        if isinstance(tree, dict) and isinstance(tree.get(key), dict):
            return tree[key]
    return tree


def _swin_layout(t) -> bool:
    """True for a state dict with SwinIR's stem and block layout (which
    HAT's shares)."""
    return isinstance(t, dict) and "conv_first.weight" in t \
        and _BLOCK.format(0, 0) + "attn.qkv.weight" in t


def is_swinir(tree) -> bool:
    """True for a SwinIR state dict, wrapped or bare; False for HAT's
    (`models.hat`), whose blocks carry a convolution branch and whose
    groups end in an overlapping cross-attention block."""
    t = unwrap(tree)
    return _swin_layout(t) \
        and _BLOCK.format(0, 0) + "conv_block.cab.0.weight" not in t \
        and "layers.0.residual_group.overlap_attn.qkv.weight" not in t


def _shape(tree, key) -> tuple:
    return tuple(np.shape(tree[key]))


def config_of(tree) -> dict:
    """The widths of a SwinIR state dict: ``embed_dim``, ``in_chans``,
    ``depths``, ``num_heads``, ``window_size``, ``mlp_hidden``,
    ``num_feat``, ``upscale``, ``out_chans``; with ``img_range`` and
    ``mean`` of the classical-SR models.  ValueError for what this port
    does not run: an absolute position embedding, a residual connection
    other than '1conv', an upsampler other than 'pixelshuffle'."""
    t = unwrap(tree)
    if not is_swinir(t):
        raise ValueError("not a SwinIR state dict")
    return layout_config(t, "SwinIR")


def layout_config(t: dict, name: str) -> dict:
    """`config_of`'s widths of a bare state dict in SwinIR's layout (and
    HAT's, which shares its stem, blocks and upsampler); ``name`` for the
    refusals."""
    if "absolute_pos_embed" in t:
        raise ValueError(f"{name} with ape=True is not supported")
    if "layers.0.conv.weight" not in t:
        raise ValueError("only resi_connection='1conv' is supported")
    if "conv_before_upsample.0.weight" not in t:
        raise ValueError("only upsampler='pixelshuffle' is supported")
    embed, in_chans = _shape(t, "conv_first.weight")[:2]
    depths, heads = [], []
    while _BLOCK.format(len(depths), 0) + "norm1.weight" in t:
        i = len(depths)
        n = 0
        while _BLOCK.format(i, n) + "norm1.weight" in t:
            n += 1
        depths.append(n)
        heads.append(_shape(t, _BLOCK.format(i, 0)
                            + "attn.relative_position_bias_table")[1])
    rows = _shape(t, _BLOCK.format(0, 0)
                  + "attn.relative_position_bias_table")[0]
    window = (math.isqrt(rows) + 1) // 2
    num_feat = _shape(t, "conv_before_upsample.0.weight")[0]
    up, n_up = 1, 0
    while f"upsample.{2 * n_up}.weight" in t:
        ratio = _shape(t, f"upsample.{2 * n_up}.weight")[0] // num_feat
        up *= math.isqrt(ratio)
        n_up += 1
    if n_up == 0:
        raise ValueError("the state dict has no upsample convolutions")
    return {"embed_dim": int(embed), "in_chans": int(in_chans),
            "depths": depths, "num_heads": [int(h) for h in heads],
            "window_size": int(window),
            "mlp_hidden": int(_shape(t, _BLOCK.format(0, 0)
                                     + "mlp.fc1.weight")[0]),
            "num_feat": int(num_feat), "upscale": int(up),
            "out_chans": int(_shape(t, "conv_last.weight")[0]),
            "patch_norm": "patch_embed.norm.weight" in t,
            "img_range": IMG_RANGE, "mean": MEAN}


def padded_size(h: int, w: int, window: int = 8) -> tuple:
    """SwinIR's `check_image_size`: each side up to a multiple of the
    window."""
    return h + (-h) % window, w + (-w) % window


def _t(v, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                           else v).to(device=device, dtype=dtype)


def _d2s_order(w: torch.Tensor, factor: int) -> torch.Tensor:
    """A PixelShuffle convolution's output channels (c*f*f + fy*f + fx)
    reordered to `ops.pixel_shuffle.depth_to_space`'s ((fy*f + fx)*C +
    c)."""
    c = w.shape[0] // (factor * factor)
    perm = torch.arange(w.shape[0]).reshape(c, factor * factor).t() \
        .reshape(-1)
    return w[perm.to(w.device)]


class Weights:
    """A bare state dict's tensors on ``device`` in a tier's types
    (``dt``: bf16 for the fast tier, f32 for the exact one)."""

    def __init__(self, t: dict, device, dt):
        self.t, self.device, self.dt = t, device, dt

    def conv(self, name, fixed=None) -> tuple:
        """A convolution's (weight in channels-last memory, bias) in
        ``dt``; ``fixed`` reorders both first."""
        w = _t(self.t[name + ".weight"], self.device)
        b = _t(self.t[name + ".bias"], self.device)
        if fixed is not None:
            w, b = fixed(w), fixed(b)
        return (w.to(self.dt).contiguous(memory_format=torch.channels_last),
                b.to(self.dt))

    def lin(self, name) -> tuple:
        """A linear layer's (weight, bias) in ``dt``."""
        return _t(self.t[name + ".weight"], self.device, self.dt), \
            _t(self.t[name + ".bias"], self.device, self.dt)

    def ln(self, name) -> tuple:
        """A LayerNorm's (weight, bias) in f32."""
        return _t(self.t[name + ".weight"], self.device), \
            _t(self.t[name + ".bias"], self.device)

    def mlp(self, prefix, fast: bool) -> dict:
        """A block's MLP: as `ops.cuda.swin_mlp.prepare` lays it out
        (``mlp``) in the fast tier, its ``fc1`` and ``fc2`` in the exact
        one."""
        fc1, fc2 = self.lin(prefix + "mlp.fc1"), self.lin(prefix + "mlp.fc2")
        return {"mlp": swin_mlp.prepare(fc1, fc2)} if fast \
            else {"fc1": fc1, "fc2": fc2}


def prepare_ends(wt: Weights, cfg: dict, fast: bool) -> dict:
    """The network's stem and tail, shared with HAT: the mean, conv_first,
    the patch embedding's and the final LayerNorm, conv_after_body, the
    pixel-shuffle upsampler (its weights in `ops.pixel_shuffle`'s channel
    order) and conv_last (bf16 operands summed in f32 in the fast
    tier)."""
    t, device = wt.t, wt.device
    ups, k = [], 0
    while f"upsample.{k}.weight" in t:
        r = math.isqrt(_shape(t, f"upsample.{k}.weight")[0]
                       // cfg["num_feat"])
        ups.append((wt.conv(f"upsample.{k}",
                            lambda v, r=r: _d2s_order(v, r)), r))
        k += 2
    wl, bl = _t(t["conv_last.weight"], device), _t(t["conv_last.bias"],
                                                   device)
    if fast:        # bf16 operands, f32 sums and output
        wl = wl.to(wt.dt).float()
    return {"cfg": cfg, "fast": fast, "dtype": wt.dt,
            "mean": torch.tensor(cfg["mean"], device=device).view(1, -1, 1, 1),
            "conv_first": wt.conv("conv_first"),
            "patch_norm": wt.ln("patch_embed.norm") if cfg["patch_norm"]
            else None,
            "norm": wt.ln("norm"),
            "conv_after_body": wt.conv("conv_after_body"),
            "conv_before_upsample": wt.conv("conv_before_upsample.0"),
            "upsample": ups,
            "conv_last": (wl.contiguous(memory_format=torch.channels_last),
                          bl)}


def prepare(tree, device="cuda", fast: bool = False) -> dict:
    """The state dict ``tree`` (tensors or arrays; wrapped or bare) on
    ``device`` in the tier's types: linear and conv weights and biases
    bf16 (fast) or f32, LayerNorms f32, each block's relative-position
    bias gathered to (heads, w*w, w*w) f32 and its shift; in the fast
    tier each block's MLP as `ops.cuda.swin_mlp.prepare` lays it out
    (``mlp``), in the exact tier its ``fc1`` and ``fc2``."""
    t = unwrap(tree)
    cfg = config_of(t)
    device = torch.device(device)
    wt = Weights(t, device, torch.bfloat16 if fast else torch.float32)
    win = cfg["window_size"]
    layers = []
    for i, depth in enumerate(cfg["depths"]):
        blocks = []
        for j in range(depth):
            p = _BLOCK.format(i, j)
            blocks.append({
                "norm1": wt.ln(p + "norm1"), "norm2": wt.ln(p + "norm2"),
                "qkv": wt.lin(p + "attn.qkv"),
                "proj": wt.lin(p + "attn.proj"), **wt.mlp(p, fast),
                "bias": relative_bias(_t(t[p + "attn.relative_position_"
                                           "bias_table"], device), win),
                "shift": 0 if j % 2 == 0 else win // 2})
        layers.append({"blocks": blocks,
                       "conv": wt.conv(f"layers.{i}.conv")})
    return {**prepare_ends(wt, cfg, fast), "layers": layers}


def _add_norm(x: torch.Tensor, y, norm, dt, fast: bool, x_out=None,
              z=None, z_scale=None, z_bias=None, h_width=None) -> tuple:
    """(s, h) of `ops.cuda.add_layernorm`: ``s = x + y`` (into ``x_out``;
    ``x`` where no ``y``; HAT's third term ``z_scale * (z + z_bias)``
    added after ``y``) and ``h`` = LN(s) (or s) in ``dt`` (rows of
    ``h_width``, zero-padded).  The fast tier calls the
    op, which launches the kernel on CUDA tensors (and raises for a width
    it refuses) and runs the plain version on CPU tensors; the exact tier
    takes the plain version, inside ``swinir.norm_plain``."""
    if fast:
        return add_layernorm.add_layernorm(x, y, norm, dt, x_out, LN_EPS,
                                           z, z_scale, z_bias, h_width)
    with span("swinir.norm_plain"):
        return add_layernorm.add_layernorm_reference(x, y, norm, dt, x_out,
                                                     LN_EPS, z, z_scale,
                                                     z_bias, h_width)


def _to_map(t: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """(F, P*Q, C) tokens -> (F, C, P, Q) in channels-last memory (a
    view)."""
    return t.reshape(t.shape[0], ph, pw, -1).permute(0, 3, 1, 2)


def _to_tokens(x: torch.Tensor) -> torch.Tensor:
    """(F, C, P, Q) -> (F, P*Q, C) (a view of channels-last memory)."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, x.shape[1])


def _conv(x: torch.Tensor, wb) -> torch.Tensor:
    w, b = wb
    return F.conv2d(x.contiguous(memory_format=torch.channels_last), w, b,
                    padding=w.shape[-1] // 2)


def _block(t: torch.Tensor, hn: list, blk: dict, nxt, ph: int, pw: int,
           fast: bool, dt, fresh: bool = False) -> torch.Tensor:
    """One Swin transformer layer on the f32 residual stream ``t``; ``hn``
    holds its ``norm1`` alone.  The block pops that copy, so that it is
    freed once qkv has read it, puts the stream's ``nxt`` norm in ``dt``
    in its place (the next block's ``norm1``; None: the plain cast the
    group's convolution reads) and returns the stream.  The stream is
    updated in place, but for the first add when ``fresh``: the group's
    input still holds its residual."""
    qkv = F.linear(hn.pop(), *blk["qkv"])
    attn = window_attn if fast else window_attn_reference
    o = attn(qkv, blk["bias"], blk["shift"], ph, pw)
    del qkv
    t, h = _add_norm(t, F.linear(o, *blk["proj"]), blk["norm2"], dt, fast,
                     None if fresh else t)
    del o
    y = mlp(h, blk, fast)
    del h
    t, h = _add_norm(t, y, nxt, dt, fast, t)
    hn.append(h)
    return t


def mlp(h: torch.Tensor, blk: dict, fast: bool) -> torch.Tensor:
    """A block's MLP on its normed tokens: `ops.cuda.swin_mlp` (fast),
    or ``F.linear``, ``F.gelu``, ``F.linear``."""
    if fast:
        return swin_mlp.swin_mlp(h, blk["mlp"])
    return F.linear(F.gelu(F.linear(h, *blk["fc1"])), *blk["fc2"])


def forward(net: dict, x: torch.Tensor, to_u8: bool = True) -> torch.Tensor:
    """(F, H, W, 3) frames on the net's device, uint8 or float in [0, 1]
    -> (F, s*H, s*W, 3): uint8 (``to_u8``: floor(clip(y, 0, 1) * 255 +
    0.5)) or float32, unclipped."""
    ctx = exact_f32() if not net["fast"] else contextlib.nullcontext()
    with ctx, torch.no_grad():
        return _forward(net, x, to_u8)


def _forward(net: dict, x: torch.Tensor, to_u8: bool) -> torch.Tensor:
    cfg, fast, dt = net["cfg"], net["fast"], net["dtype"]
    h, w = x.shape[1:3]
    ph, pw = padded_size(h, w, cfg["window_size"])
    layers = net["layers"]
    with span("swinir.embed"):
        f0, t, hn = embed(net, x, ph, pw, layers[0]["blocks"][0]["norm1"])
        hn = [hn]
    for i, layer in enumerate(layers):
        with span("swinir.rstb"):
            r, blocks = t, layer["blocks"]
            for j, blk in enumerate(blocks):
                nxt = blocks[j + 1]["norm1"] if j + 1 < len(blocks) else None
                t = _block(t, hn, blk, nxt, ph, pw, fast, dt, fresh=j == 0)
            y = _to_tokens(_conv(_to_map(hn.pop(), ph, pw), layer["conv"]))
            nxt = (layers[i + 1]["blocks"][0]["norm1"]
                   if i + 1 < len(layers) else net["norm"])
            t, normed = _add_norm(r, y, nxt, dt, fast, r)
            hn.append(normed)
            del r, y, normed
    del t
    with span("swinir.upsample"):
        return upsample(net, hn.pop(), [f0], h, w, to_u8)


def embed(net: dict, x: torch.Tensor, ph: int, pw: int, norm1,
          h_width=None) -> tuple:
    """The stem on (F, H, W, 3) frames: (f0, t, h), conv_first's output
    (F, C, ph, pw) in channels-last memory, the f32 stream (F, ph*pw, C)
    after the patch embedding's LayerNorm, and its ``norm1`` in the tier's
    type (the first block's input; rows of ``h_width``, zero-padded, as
    `ops.cuda.add_layernorm` writes them)."""
    cfg, fast, dt = net["cfg"], net["fast"], net["dtype"]
    h, w = x.shape[1:3]
    x = x.permute(0, 3, 1, 2)
    x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
    x = (x - net["mean"]) * cfg["img_range"]
    x = F.pad(x, (0, pw - w, 0, ph - h), mode="reflect")
    f0 = _conv(x.to(dt), net["conv_first"])
    _, t = _add_norm(_to_tokens(f0), None, net["patch_norm"], torch.float32,
                     fast)
    return f0, t, _add_norm(t, None, norm1, dt, fast, h_width=h_width)[1]


def upsample(net: dict, hn: torch.Tensor, f0: list, h: int, w: int,
             to_u8: bool) -> torch.Tensor:
    """The tail: conv_after_body on ``hn`` (the final LayerNorm's output,
    (F, ph*pw, C) tokens) plus ``f0.pop()`` (conv_first's output, handed
    in a list so that it is freed here), conv_before_upsample, the
    upsampler and conv_last; the (F, s*h, s*w, 3) frames as `forward`
    returns them."""
    cfg, fast = net["cfg"], net["fast"]
    s = cfg["upscale"]
    ph, pw = f0[0].shape[2:]
    b = _conv(_to_map(hn, ph, pw), net["conv_after_body"]) + f0.pop()
    del hn
    y = F.leaky_relu(_conv(b, net["conv_before_upsample"]), 0.01)
    del b
    for wb, r in net["upsample"]:
        y = depth_to_space(_conv(y, wb).permute(0, 2, 3, 1), r) \
            .permute(0, 3, 1, 2)
    if fast:
        with tf32_on_bf16():
            y = _conv(y.float(), net["conv_last"])
    else:
        y = _conv(y, net["conv_last"])
    y = (y / cfg["img_range"] + net["mean"])[:, :, :s * h, :s * w]
    y = y.permute(0, 2, 3, 1)
    if to_u8:
        y = torch.floor(torch.clamp(y, 0.0, 1.0) * 255.0 + 0.5) \
            .to(torch.uint8)
    return y.contiguous()
