"""SwinIR for classical super-resolution, plain: the reference that the
port's `models/swinir.py` is held to.

It follows `models/network_swinir.py` of
https://github.com/JingyunLiang/SwinIR (Liang et al., "SwinIR: Image
Restoration Using Swin Transformer", ICCVW 2021, arXiv:2108.10257) with
``upsampler='pixelshuffle'``, ``resi_connection='1conv'``,
``patch_norm=True``, ``ape=False``: NCHW float32 through
`torch.nn.functional`, the windows cut by `torch.roll` and reshapes as
`window_partition` / `window_reverse` cut them, the mask built as
`calculate_mask` builds it, with TF32 off for matrix products and cuDNN
alike.  Departures from the original: none in the arithmetic; the frame
is processed one at a time, and the parameters come from a state dict
rather than modules.  It imports nothing of this repository's packages
and no JAX (the benchmark holds a byte-for-byte copy,
`portbench/reference/swinir.py`).

Options for the checks: ``quant`` rounds the operands of every linear
layer, convolution and attention product first (the lower-precision
control; sums stay float32), and ``fault`` plants a known mistake:
"no_mask" (the shifted blocks' mask left out), "no_bias" (the
relative-position bias left out) or "unshifted" (every block unshifted).

`draw_weights` makes a state dict in the original's layout (with its
``relative_position_index`` and ``attn_mask`` buffers) from a seed, by a
draw under which every block moves the result (SwinIR's own
initialisation, truncated normal 0.02 and zero biases, makes the blocks
add almost nothing):
- linear and convolution weights N(0, 1/fan_in), biases N(0, 0.05^2);
- relative-position tables N(0, 1);
- LayerNorm weights 1 + N(0, 0.1^2), biases N(0, 0.1^2);
- conv_last's weights N(0, LAST_GAIN^2 / fan_in) and bias 0, so that the
  output stays within [0, 1] but for a small share of its values.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

LAST_GAIN = 0.15
FAULTS = ("no_mask", "no_bias", "unshifted")


def _block(i: int, j: int) -> str:
    return f"layers.{i}.residual_group.blocks.{j}."


@contextlib.contextmanager
def exact():
    """float32 products with TF32 off (matmul and cuDNN), restored on
    exit."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    cudnn = torch.backends.cudnn
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic,
                         allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def relative_position_index(ws: int) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws),
                                        indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0)
    rel = rel.contiguous()
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int,
                   w: int) -> torch.Tensor:
    b = int(windows.shape[0] / (h * w / ws / ws))
    x = windows.view(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


def calculate_mask(h: int, w: int, ws: int, shift: int,
                   device="cpu") -> torch.Tensor:
    img_mask = torch.zeros((1, h, w, 1), device=device)
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for wsl in slices:
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    mw = window_partition(img_mask, ws).view(-1, ws * ws)
    m = mw.unsqueeze(1) - mw.unsqueeze(2)
    return m.masked_fill(m != 0, -100.0).masked_fill(m == 0, 0.0)


def draw_weights(seed: int, cfg: dict) -> dict:
    """A state dict in the original's layout, as float32 tensors (and its
    int64 ``relative_position_index`` buffers), from ``seed``."""
    r = np.random.default_rng(seed)
    c, cin = cfg["embed_dim"], cfg["in_chans"]
    ws, nf = cfg["window_size"], cfg["num_feat"]
    hidden = int(c * cfg["mlp_ratio"])
    p: dict = {}

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    def conv(name, ci, co, k=3, gain=1.0, bias_std=0.05):
        p[name + ".weight"] = t(r.normal(0, gain / np.sqrt(ci * k * k),
                                         (co, ci, k, k)))
        p[name + ".bias"] = t(r.normal(0, bias_std, co))

    def lin(name, ci, co):
        p[name + ".weight"] = t(r.normal(0, 1 / np.sqrt(ci), (co, ci)))
        p[name + ".bias"] = t(r.normal(0, 0.05, co))

    def ln(name):
        p[name + ".weight"] = t(1 + r.normal(0, 0.1, c))
        p[name + ".bias"] = t(r.normal(0, 0.1, c))

    conv("conv_first", cin, c)
    ln("patch_embed.norm")
    size = cfg["img_size"]
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        for j in range(depth):
            b = _block(i, j)
            ln(b + "norm1")
            if j % 2:
                p[b + "attn_mask"] = calculate_mask(size, size, ws, ws // 2)
            p[b + "attn.relative_position_bias_table"] = t(
                r.normal(0, 1, ((2 * ws - 1) ** 2, heads)))
            p[b + "attn.relative_position_index"] = \
                relative_position_index(ws)
            lin(b + "attn.qkv", c, 3 * c)
            lin(b + "attn.proj", c, c)
            ln(b + "norm2")
            lin(b + "mlp.fc1", c, hidden)
            lin(b + "mlp.fc2", hidden, c)
        conv(f"layers.{i}.conv", c, c)
    ln("norm")
    conv("conv_after_body", c, c)
    conv("conv_before_upsample.0", c, nf)
    scale, k = cfg["upscale"], 0
    while scale > 1:
        conv(f"upsample.{k}", nf, 4 * nf)
        scale //= 2
        k += 2
    conv("conv_last", nf, cfg["out_chans"], gain=LAST_GAIN, bias_std=0.0)
    return p


def num_parameters(p: dict) -> int:
    """Learned values: every entry but the index and mask buffers."""
    return sum(v.numel() for k, v in p.items()
               if not k.endswith(("relative_position_index", "attn_mask")))


def _attention(x, p, b, heads, ws, mask, q, fault):
    bw, n, c = x.shape
    qkv = F.linear(q(x), q(p[b + "qkv.weight"]), p[b + "qkv.bias"])
    qkv = qkv.reshape(bw, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    qq, kk, vv = qkv[0], qkv[1], qkv[2]
    qq = qq * (c // heads) ** -0.5
    attn = q(qq) @ q(kk).transpose(-2, -1)
    if fault != "no_bias":
        table = p[b + "relative_position_bias_table"]
        idx = relative_position_index(ws).to(table.device)
        bias = table[idx.view(-1)].view(n, n, -1).permute(2, 0, 1)
        attn = attn + bias.unsqueeze(0)
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.view(bw // nw, nw, heads, n, n) \
            + mask.unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, heads, n, n)
    attn = torch.softmax(attn, dim=-1)
    x = (q(attn) @ q(vv)).transpose(1, 2).reshape(bw, n, c)
    return F.linear(q(x), q(p[b + "proj.weight"]), p[b + "proj.bias"])


def _swin_block(t, p, b, heads, ws, shift, hw, q, fault):
    h, w = hw
    bsz, _, c = t.shape
    shortcut = t
    x = F.layer_norm(t, (c,), p[b + "norm1.weight"], p[b + "norm1.bias"],
                     1e-5).view(bsz, h, w, c)
    if shift:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
    xw = window_partition(x, ws).view(-1, ws * ws, c)
    mask = calculate_mask(h, w, ws, shift, t.device) \
        if shift and fault != "no_mask" else None
    aw = _attention(xw, p, b + "attn.", heads, ws, mask, q, fault)
    x = window_reverse(aw.view(-1, ws, ws, c), ws, h, w)
    if shift:
        x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
    t = shortcut + x.view(bsz, h * w, c)
    y = F.layer_norm(t, (c,), p[b + "norm2.weight"], p[b + "norm2.bias"],
                     1e-5)
    y = F.gelu(F.linear(q(y), q(p[b + "mlp.fc1.weight"]),
                        p[b + "mlp.fc1.bias"]))
    return t + F.linear(q(y), q(p[b + "mlp.fc2.weight"]),
                        p[b + "mlp.fc2.bias"])


def forward(p: dict, x: torch.Tensor, cfg: dict, quant=None,
            fault=None) -> torch.Tensor:
    """(N, 3, H, W) sRGB in [0, 1] -> (N, 3, sH, sW) float32, unclipped."""
    if fault not in (None,) + FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    q = quant or (lambda v: v)
    ws = cfg["window_size"]

    def conv(v, name):
        return F.conv2d(q(v), q(p[name + ".weight"]), p[name + ".bias"],
                        padding=1)

    h, w = x.shape[2:]
    mean = torch.tensor(cfg["mean"], device=x.device).view(1, 3, 1, 1)
    x = F.pad(x, (0, (ws - w % ws) % ws, 0, (ws - h % ws) % ws), "reflect")
    x = (x - mean) * cfg["img_range"]
    f = conv(x, "conv_first")
    hw = f.shape[2:]
    c = f.shape[1]

    def flat(v):
        return v.flatten(2).transpose(1, 2)

    def unflat(t):
        return t.transpose(1, 2).view(t.shape[0], c, *hw)

    t = F.layer_norm(flat(f), (c,), p["patch_embed.norm.weight"],
                     p["patch_embed.norm.bias"], 1e-5)
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        r = t
        for j in range(depth):
            shift = ws // 2 if j % 2 and fault != "unshifted" else 0
            t = _swin_block(t, p, _block(i, j), heads, ws, shift, hw, q,
                            fault)
        t = flat(conv(unflat(t), f"layers.{i}.conv")) + r
    t = F.layer_norm(t, (c,), p["norm.weight"], p["norm.bias"], 1e-5)
    y = conv(unflat(t), "conv_after_body") + f
    y = F.leaky_relu(conv(y, "conv_before_upsample.0"), 0.01)
    scale, k = cfg["upscale"], 0
    while scale > 1:
        y = F.pixel_shuffle(conv(y, f"upsample.{k}"), 2)
        scale //= 2
        k += 2
    y = conv(y, "conv_last") / cfg["img_range"] + mean
    s = cfg["upscale"]
    return y[:, :, :h * s, :w * s]


def to_u8(x: torch.Tensor) -> torch.Tensor:
    """floor(clip(x, 0, 1) * 255 + 0.5)."""
    return torch.floor(torch.clamp(x, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def upscale_u8(p: dict, img: np.ndarray, cfg: dict, device, quant=None,
               fault=None) -> np.ndarray:
    """(H, W, 3) u8 -> (sH, sW, 3) u8 through `forward`, one frame, TF32
    off; ``p`` holds tensors on ``device``."""
    x = torch.as_tensor(np.asarray(img), device=device).permute(2, 0, 1)[None]
    with exact(), torch.no_grad():
        y = forward(p, x.float() / 255.0, cfg, quant, fault)
        return to_u8(y)[0].permute(1, 2, 0).cpu().numpy()


def clipped_share(ref_u8: np.ndarray) -> float:
    """The share of the reference's u8 codes at 0 or 255."""
    return float(np.mean((ref_u8 == 0) | (ref_u8 == 255)))
