"""HAT for classical super-resolution, plain: the reference that the port's
`models/hat.py` is held to.

It follows `hat/archs/hat_arch.py` of https://github.com/XPixelGroup/HAT
(Chen, Wang, Zhou, Qiao, Dong, "Activating More Pixels in Image
Super-Resolution Transformer", CVPR 2023, arXiv:2205.04437) with
``upsampler='pixelshuffle'``, ``resi_connection='1conv'``,
``patch_norm=True``, ``ape=False``, as
``options/test/HAT_SRx4_ImageNet-pretrain.yml`` builds it: NCHW float32
through `torch.nn.functional`, the windows cut by `torch.roll` and
reshapes as `window_partition` / `window_reverse` cut them, the
overlapping keys cut by `F.unfold` as ``nn.Unfold`` cuts them, the
relative-position indices built as `calculate_rpi_sa` and
`calculate_rpi_oca` build them (the latter's negative indices wrapped, as
PyTorch's indexing wraps them) and the mask as `calculate_mask` builds
it, with TF32 off for matrix products and cuDNN alike.  The frame is
reflect-padded at the bottom and right to whole windows first, as HAT's
test-time `pre_process` pads it.

Departures from the original: none in the arithmetic.  The frame is
processed one at a time, attention in blocks of `WINDOWS_A_BLOCK`
windows (so that a 544x960 frame's scores fit on one card), and the
parameters come from a state dict rather than modules.  It imports
nothing of this repository's packages and no JAX (the benchmark holds a
byte-for-byte copy, `portbench/reference/hat.py`).

Options for the checks: ``quant`` rounds the operands of every linear
layer, convolution and attention product first (the lower-precision
control; sums stay float32), and ``fault`` plants a known mistake:
"no_overlap" (the overlapping cross-attention's keys taken from the
query's own window), "pad_masked" (its keys outside the frame masked
out, where HAT scores them at their bias), "unshifted" (every block
unshifted), "no_ca" (the channel attention's gate left at 1) or
"no_cab" (the convolution branch left out).

`draw_weights` makes a state dict in the original's layout (with HAT's
``relative_position_index_SA`` and ``relative_position_index_OCA``
buffers) from a seed, by SwinIR's reference draw, under which every
block moves the result (HAT's own initialisation, truncated normal 0.02
and zero biases, makes the blocks add almost nothing):
- linear and convolution weights N(0, 1/fan_in); biases N(0, 0.05^2);
- but the convolution branch's second convolution (``cab.2``) at
  N(0, 1/(conv_scale^2 fan_in)), so that ``conv_scale`` times the branch
  is of the attention's order, as in a trained HAT, and a wrong branch
  or gate moves the output beyond the fast tier's rounding; and the
  channel attention's first 1x1 convolution (``attention.1``) at
  N(0, conv_scale^2/fan_in), so that its gate sees the mean it would
  see at N(0, 1/fan_in) and stays between 0.3 and 0.7;
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
FAULTS = ("no_overlap", "pad_masked", "unshifted", "no_ca", "no_cab")
WINDOWS_A_BLOCK = 128


def _group(i: int) -> str:
    return f"layers.{i}.residual_group."


def _block(i: int, j: int) -> str:
    return f"layers.{i}.residual_group.blocks.{j}."


def overlap_size(cfg: dict) -> int:
    """The overlapping window's side: 24 for window 16, ratio 0.5."""
    ws = cfg["window_size"]
    return int(ws * cfg["overlap_ratio"]) + ws


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


def calculate_rpi_sa(ws: int) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws),
                                        indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0)
    rel = rel.contiguous()
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def calculate_rpi_oca(ws: int, overlap_ratio: float) -> torch.Tensor:
    wse = ws + int(overlap_ratio * ws)
    ori = torch.flatten(torch.stack(torch.meshgrid(
        torch.arange(ws), torch.arange(ws), indexing="ij")), 1)
    ext = torch.flatten(torch.stack(torch.meshgrid(
        torch.arange(wse), torch.arange(wse), indexing="ij")), 1)
    rel = ext[:, None, :] - ori[:, :, None]
    rel = rel.permute(1, 2, 0).contiguous()
    rel[:, :, 0] += ws - wse + 1
    rel[:, :, 1] += ws - wse + 1
    rel[:, :, 0] *= ws + wse - 1
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
    int64 relative-position index buffers), from ``seed``."""
    r = np.random.default_rng(seed)
    c, cin = cfg["embed_dim"], cfg["in_chans"]
    ws, nf = cfg["window_size"], cfg["num_feat"]
    wse = overlap_size(cfg)
    hidden = int(c * cfg["mlp_ratio"])
    cc, cs = c // cfg["compress_ratio"], c // cfg["squeeze_factor"]
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

    def transformer(b, heads, rows):
        ln(b + "norm1")
        p[b + "attn.relative_position_bias_table" if "blocks" in b
          else b + "relative_position_bias_table"] = t(
            r.normal(0, 1, (rows, heads)))
        lin(b + ("attn.qkv" if "blocks" in b else "qkv"), c, 3 * c)
        lin(b + ("attn.proj" if "blocks" in b else "proj"), c, c)
        ln(b + "norm2")
        lin(b + "mlp.fc1", c, hidden)
        lin(b + "mlp.fc2", hidden, c)

    conv("conv_first", cin, c)
    p["relative_position_index_SA"] = calculate_rpi_sa(ws)
    p["relative_position_index_OCA"] = calculate_rpi_oca(
        ws, cfg["overlap_ratio"])
    ln("patch_embed.norm")
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        for j in range(depth):
            b = _block(i, j)
            transformer(b, heads, (2 * ws - 1) ** 2)
            cab = b + "conv_block.cab."
            conv(cab + "0", c, cc)
            conv(cab + "2", cc, c, gain=1 / cfg["conv_scale"])
            conv(cab + "3.attention.1", c, cs, k=1, gain=cfg["conv_scale"])
            conv(cab + "3.attention.3", cs, c, k=1)
        transformer(_group(i) + "overlap_attn.", heads, (ws + wse - 1) ** 2)
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
    """Learned values: every entry but the index buffers."""
    return sum(v.numel() for k, v in p.items()
               if not k.startswith("relative_position_index"))


def _scores_softmax_v(q, k, v, bias, mask, qz):
    """softmax(q k^T + bias (+ mask)) v over windows, ``q`` already
    scaled; (bw, heads, n, d) each, ``mask`` (bw, n, m) or None."""
    attn = qz(q) @ qz(k).transpose(-2, -1) + bias.unsqueeze(0)
    if mask is not None:
        attn = attn + mask.unsqueeze(1)
    return qz(torch.softmax(attn, dim=-1)) @ qz(v)


def _window_attention(xw, p, b, heads, ws, mask, q):
    """HAB's `WindowAttention` on (windows, ws*ws, C) normed tokens, in
    blocks of windows."""
    bw, n, c = xw.shape
    d = c // heads
    table = p[b + "relative_position_bias_table"]
    idx = p["relative_position_index_SA"].to(table.device)
    bias = table[idx.view(-1)].view(n, n, -1).permute(2, 0, 1).contiguous()
    out = []
    for s in range(0, bw, WINDOWS_A_BLOCK):
        x = xw[s:s + WINDOWS_A_BLOCK]
        qkv = F.linear(q(x), q(p[b + "qkv.weight"]), p[b + "qkv.bias"])
        qkv = qkv.reshape(x.shape[0], n, 3, heads, d).permute(2, 0, 3, 1, 4)
        m = None if mask is None else mask[s:s + WINDOWS_A_BLOCK]
        o = _scores_softmax_v(qkv[0] * d ** -0.5, qkv[1], qkv[2], bias, m, q)
        o = o.transpose(1, 2).reshape(x.shape[0], n, c)
        out.append(F.linear(q(o), q(p[b + "proj.weight"]),
                            p[b + "proj.bias"]))
    return torch.cat(out)


def _cab(x, p, b, q, fault):
    """HAB's conv branch on an (N, C, H, W) map: conv 3x3 C -> C/cr, GELU,
    conv 3x3 back to C, then `ChannelAttention`'s gate."""
    cab = b + "conv_block.cab."

    def conv(v, name, pad):
        return F.conv2d(q(v), q(p[name + ".weight"]), p[name + ".bias"],
                        padding=pad)
    z = conv(F.gelu(conv(x, cab + "0", 1)), cab + "2", 1)
    if fault == "no_ca":
        return z
    y = F.adaptive_avg_pool2d(z, 1)
    y = F.relu(conv(y, cab + "3.attention.1", 0))
    return z * torch.sigmoid(conv(y, cab + "3.attention.3", 0))


def _hab(t, p, b, cfg, heads, shift, hw, q, fault):
    ws = cfg["window_size"]
    h, w = hw
    bsz, _, c = t.shape
    shortcut = t
    x = F.layer_norm(t, (c,), p[b + "norm1.weight"], p[b + "norm1.bias"],
                     1e-5).view(bsz, h, w, c)
    conv_x = 0.0
    if fault != "no_cab":
        conv_x = _cab(x.permute(0, 3, 1, 2), p, b, q, fault) \
            .permute(0, 2, 3, 1).contiguous().view(bsz, h * w, c)
    if shift:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
    xw = window_partition(x, ws).view(-1, ws * ws, c)
    mask = calculate_mask(h, w, ws, shift, t.device).repeat(bsz, 1, 1) \
        if shift else None
    aw = _window_attention(xw, p, b + "attn.", heads, ws, mask, q)
    x = window_reverse(aw.view(-1, ws, ws, c), ws, h, w)
    if shift:
        x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
    t = shortcut + x.view(bsz, h * w, c) + conv_x * cfg["conv_scale"]
    return t + _mlp(t, p, b, q)


def _mlp(t, p, b, q):
    c = t.shape[-1]
    y = F.layer_norm(t, (c,), p[b + "norm2.weight"], p[b + "norm2.bias"],
                     1e-5)
    y = F.gelu(F.linear(q(y), q(p[b + "mlp.fc1.weight"]),
                        p[b + "mlp.fc1.bias"]))
    return F.linear(q(y), q(p[b + "mlp.fc2.weight"]), p[b + "mlp.fc2.bias"])


def _ocab(t, p, b, cfg, heads, hw, q, fault):
    """HAT's `OCAB`: queries from each window, keys and values from the
    overlapping square around it (`overlap_attention`)."""
    h, w = hw
    bsz, _, c = t.shape
    shortcut = t
    x = F.layer_norm(t, (c,), p[b + "norm1.weight"], p[b + "norm1.bias"],
                     1e-5).view(bsz, h, w, c)
    qkv = F.linear(q(x), q(p[b + "qkv.weight"]), p[b + "qkv.bias"])
    x = overlap_attention(qkv, p[b + "relative_position_bias_table"],
                          p["relative_position_index_OCA"], cfg, heads, q,
                          fault)
    t = F.linear(q(x), q(p[b + "proj.weight"]), p[b + "proj.bias"]) \
        + shortcut
    return t + _mlp(t, p, b, q)


def overlap_attention(qkv, table, rpi, cfg, heads, q=None, fault=None):
    """The attention inside `OCAB` on the ``qkv`` projection's (b, h, w,
    3C) output: each window's queries against the keys and values of the
    square around it, cut by ``nn.Unfold`` (zeros outside the frame), with
    the bias ``table[rpi]``; the merged (b, h*w, C) output."""
    q = q or (lambda v: v)
    ws = cfg["window_size"]
    wse = overlap_size(cfg)
    bsz, h, w, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    qkv = qkv.reshape(bsz, h, w, 3, c).permute(3, 0, 4, 1, 2)
    qm = qkv[0].permute(0, 2, 3, 1)
    kv = torch.cat((qkv[1], qkv[2]), dim=1)
    qw = window_partition(qm, ws).view(-1, ws * ws, c)
    bias = table[rpi.to(table.device).view(-1)].view(ws * ws, wse * wse, -1)
    if fault == "no_overlap":     # the query's own window, its bias slice
        o = (wse - ws) // 2
        bias = bias.view(ws * ws, wse, wse, -1)[:, o:o + ws, o:o + ws]
        wse, pad = ws, 0
    else:
        pad = (wse - ws) // 2
    bias = bias.reshape(ws * ws, wse * wse, -1).permute(2, 0, 1).contiguous()
    kvw = F.unfold(kv, kernel_size=(wse, wse), stride=ws, padding=pad)
    nw = kvw.shape[-1]
    kvw = kvw.view(bsz, 2, c, wse * wse, nw).permute(1, 0, 4, 3, 2) \
        .reshape(2, bsz * nw, wse * wse, c).contiguous()
    mask = None
    if fault == "pad_masked":
        ones = torch.ones((1, 1, h, w), device=qkv.device)
        inside = F.unfold(ones, kernel_size=(wse, wse), stride=ws,
                          padding=pad)[0].t()              # (nw, wse*wse)
        mask = torch.where(inside > 0, 0.0, float("-inf")) \
            .unsqueeze(1).expand(nw, ws * ws, wse * wse).repeat(bsz, 1, 1)
    out = []
    for s in range(0, qw.shape[0], WINDOWS_A_BLOCK):
        e = s + WINDOWS_A_BLOCK
        n = qw[s:e].shape[0]
        qq = qw[s:e].reshape(n, ws * ws, heads, d).permute(0, 2, 1, 3)
        kk = kvw[0, s:e].reshape(n, wse * wse, heads, d).permute(0, 2, 1, 3)
        vv = kvw[1, s:e].reshape(n, wse * wse, heads, d).permute(0, 2, 1, 3)
        o = _scores_softmax_v(qq * d ** -0.5, kk, vv, bias,
                              None if mask is None else mask[s:e], q)
        out.append(o.transpose(1, 2).reshape(n, ws * ws, c))
    x = window_reverse(torch.cat(out).view(-1, ws, ws, c), ws, h, w)
    return x.view(bsz, h * w, c)


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
            t = _hab(t, p, _block(i, j), cfg, heads, shift, hw, q, fault)
        t = _ocab(t, p, _group(i) + "overlap_attn.", cfg, heads, hw, q,
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
