"""HAT for classical super-resolution (Chen, Wang, Zhou, Qiao, Dong,
"Activating More Pixels in Image Super-Resolution Transformer", CVPR
2023, arXiv:2205.04437), as `hat/archs/hat_arch.py` of
https://github.com/XPixelGroup/HAT defines it with
``upsampler='pixelshuffle'`` and ``resi_connection='1conv'``, on parameter
trees in its own state-dict layout, so that a released ``.pth``
(``HAT_SRx4_ImageNet-pretrain.pth``) loads as it is.

On (frames, H, W, 3) images in [0, 1] (u8 pixels / 255):

    x0 = reflect-pad(x - mean) at bottom and right to multiples of the window
    f  = conv_first(x0);  t = LN(flatten(f))
    residual hybrid attention groups: r = t; their blocks (HAB; shift 0,
    then window / 2, ...):
        n = LN1(t)
        u = t + proj(WMSA_s(qkv(n))) + conv_scale * CAB(n)
        t = u + fc2(GELU(fc1(LN2(u))))
      then the group's OCAB: n = LN1(t); u = t + proj(OCA(qkv(n)));
        t = u + fc2(GELU(fc1(LN2(u))))
      t = flatten(conv(unflatten(t))) + r
    b  = conv_after_body(unflatten(LN(t))) + f
    y  = conv_last(upsample(LReLU(conv_before_upsample(b))))
    out = (y + mean)[:, :s*H, :s*W]

    CAB(n) = CA(conv3x3(GELU(conv3x3(n))))     C -> C / compress -> C
    CA(z)  = z * sigmoid(W2 ReLU(W1 mean_HW(z) + b1) + b2)   per frame

WMSA_s is Swin's shifted-window attention (``ops.cuda.hat_attn.sa_attn``)
and OCA HAT's overlapping cross-attention (``oca_attn``: each window's
queries against the keys of the square around it, ``overlap_ratio`` of
the window wider, zeros outside the frame).  The widths (embedding,
heads, window, the overlapping window, the branch's compress and squeeze
widths, MLP, groups and blocks, upsampler features, scale) are read from
the tree (`config_of`); ``conv_scale`` (0.01) and ``overlap_ratio`` (0.5)
are the published model's constants, the latter checked against the OCAB
tables; ``img_range`` and ``mean`` are the classical-SR models'.  The
channel attention's mean runs over each frame's whole padded grid, so a
frame is the smallest unit that computes its own output: frames are never
tiled, and two frames of one chunk never share a mean.

The stem, the tail and the add-and-normalise, MLP and layout helpers are
`models.swinir`'s.  Two tiers (`prepare`, `forward`), as SwinIR's:
- fast (``fast=True``): GEMM and convolution operands bf16 with f32 sums
  (the branch's convolutions on cuDNN in channels-last memory); the
  rows that GEMMs and convolutions read padded with zero columns, met by
  zero weights, to whole 16-byte groups (`prepare`), so that cuBLAS and
  cuDNN take their sm90 kernels without padded copies; the
  residual stream, LayerNorm statistics, softmax, the channel mean and
  the gate in f32; both attentions on their kernels (`ops.cuda.hat_attn`,
  the plain version on the CPU), reading the block's relative-position
  table laid out at `prepare`; each add fused with the LayerNorm (or the
  bf16 cast) that reads its sum (`ops.cuda.add_layernorm`), the hybrid
  block's three-term add included, with conv_scale folded into the
  gate's per-frame, per-channel scale: 2 * (blocks + groups) + groups + 2
  launches a chunk (92 at the published widths); the MLP on
  `ops.cuda.swin_mlp` (42 launches a chunk);
- exact: float32 throughout with TF32 off (`ops.conv.exact_f32`), the
  attentions as `hat_attn_reference`, the MLP as ``F.linear``,
  ``F.gelu``, ``F.linear``.

Each stage is a `span`: ``hat.embed`` (conv_first, the patch
embedding's LayerNorm and the first block's norm1), ``hat.rhag`` (one
group, through the norm that reads its sum), ``hat.ocab`` (the group's
OCAB, inside ``hat.rhag``) and ``hat.upsample`` (conv_after_body, the
upsampler and conv_last through the output's u8 quantisation).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from rusty_sr_tpu_torch.models import swinir
from rusty_sr_tpu_torch.models.swinir import (_add_norm, _conv, _shape, _t,
                                              _to_map, _to_tokens, embed,
                                              mlp, padded_size, unwrap,
                                              upsample)
from rusty_sr_tpu_torch.ops.conv import exact_f32
from rusty_sr_tpu_torch.ops.cuda import hat_attn
from rusty_sr_tpu_torch.utils.profiling import span

NAME = "HAT"
CONV_SCALE = 0.01       # the convolution branch's weight in each block
OVERLAP_RATIO = 0.5     # the OCAB's keys reach a quarter window beyond
# The chunk loop's rules (`parallel.tiling`), as SwinIR's: a frame is one
# tile with no halo, reflect-padded on the card to whole windows; one
# frame a chunk unless the caller says.
HALO = 0
DEFAULT_CHUNK = 1

_BLOCK = swinir._BLOCK
_OCAB = "layers.{}.residual_group.overlap_attn."


def is_hat(tree) -> bool:
    """True for a HAT state dict, wrapped or bare: SwinIR's stem and block
    layout with a convolution branch in the blocks and an OCAB closing
    each group."""
    t = unwrap(tree)
    return swinir._swin_layout(t) \
        and _BLOCK.format(0, 0) + "conv_block.cab.0.weight" in t \
        and _OCAB.format(0) + "qkv.weight" in t


def config_of(tree) -> dict:
    """The widths of a HAT state dict: SwinIR's (`swinir.config_of`) with
    ``overlap_window`` (from the OCAB table's rows), ``compress`` and
    ``squeeze`` (the branch's and the channel attention's inner widths)
    and the constants ``conv_scale`` and ``overlap_ratio``.  ValueError
    for what the port does not run (SwinIR's refusals), and for tables
    that do not fit window / 2 overlapping keys."""
    t = unwrap(tree)
    if not is_hat(t):
        raise ValueError("not a HAT state dict")
    cfg = swinir.layout_config(t, NAME)
    ws = cfg["window_size"]
    rows = _shape(t, _BLOCK.format(0, 0)
                  + "attn.relative_position_bias_table")[0]
    side = math.isqrt(_shape(t, _OCAB.format(0)
                             + "relative_position_bias_table")[0])
    kw = side - ws + 1
    if rows != (2 * ws - 1) ** 2 or kw != ws + int(OVERLAP_RATIO * ws) \
            or _shape(t, _OCAB.format(0) + "relative_position_bias_table")[0] \
            != side * side:
        raise ValueError(f"HAT's tables do not fit window {ws} with "
                         f"overlap ratio {OVERLAP_RATIO}")
    cab = _BLOCK.format(0, 0) + "conv_block.cab."
    return {**cfg, "overlap_window": kw, "overlap_ratio": OVERLAP_RATIO,
            "conv_scale": CONV_SCALE,
            "compress": int(_shape(t, cab + "0.weight")[0]),
            "squeeze": int(_shape(t, cab + "3.attention.1.weight")[0])}


def prepare(tree, device="cuda", fast: bool = False) -> dict:
    """The state dict ``tree`` (tensors or arrays; wrapped or bare) on
    ``device`` in the tier's types, as `swinir.prepare` lays SwinIR's out:
    each attention's relative-position table by offset
    (`hat_attn.offset_table`, (heads, TW*TW) f32), each block's branch
    convolutions (channels-last, in the tier's type; the second one's bias
    apart, f32, for the add that reads the branch) and its channel
    attention's 1x1 convolutions as f32 (out, in) matrices, and each
    group's ``ocab``."""
    t = unwrap(tree)
    cfg = config_of(t)
    device = torch.device(device)
    wt = swinir.Weights(t, device, torch.bfloat16 if fast else torch.float32)
    ws, kw = cfg["window_size"], cfg["overlap_window"]
    c = cfg["embed_dim"]
    # In the fast tier the rows that GEMMs and convolutions read and write
    # are padded with zero columns, met by zero weights, to whole 16-byte
    # groups, so that cuBLAS and cuDNN take their sm90 kernels and cuDNN
    # makes no padded copy: the normed copies that qkv, the branch and the
    # groups' convolutions read to ``cw`` = 184 channels
    # (`ops.cuda.add_layernorm`'s ``h_width``), qkv's output to ``qw`` =
    # 544, the attention's output and proj's to ``ow`` = 192 (on an H100 a
    # frame's qkv took 0.323 ms at K = 184, N = 544 against 0.983 at 180
    # and 540, proj 0.154 ms at 192 against 0.341 at 180).
    cw = c + (-c % 8 if fast else 0)
    qw = 3 * c + (-3 * c % 8 if fast else 0)
    ow = c + (-c % 32 if fast else 0)

    def wide(wb):       # a convolution's zero weights for padded inputs
        w, b = wb
        return F.pad(w, (0, 0, 0, 0, 0, cw - c)).contiguous(
            memory_format=torch.channels_last), b

    def lin(name, n_out, n_in):     # a linear layer, padded with zeros
        w, b = wt.lin(name)
        return (F.pad(w, (0, n_in - w.shape[1], 0, n_out - w.shape[0])),
                F.pad(b, (0, n_out - b.shape[0])))

    def table(name, key_window):
        return hat_attn.offset_table(_t(t[name], device), ws, key_window)

    def ca(name):
        w = _t(t[name + ".weight"], device)
        return w.reshape(w.shape[0], w.shape[1]), _t(t[name + ".bias"],
                                                     device)

    def attention(p, key_window, sub):
        # ``sub``: the attention's own prefix inside block ``p``
        return {"norm1": wt.ln(p + "norm1"), "norm2": wt.ln(p + "norm2"),
                "qkv": lin(p + sub + "qkv", qw, cw),
                "proj": lin(p + sub + "proj", ow, ow), **wt.mlp(p, fast),
                "table": table(p + sub + "relative_position_bias_table",
                               key_window),
                "windows": (ws, key_window), "widths": (c, ow)}

    # The branch's inner width, padded in the fast tier to a multiple of 8
    # with zero filters (GELU(0) = 0, so the second convolution adds exact
    # zeros), so that cuDNN reads and writes it without padding copies.
    mid = cfg["compress"] + (-cfg["compress"] % 8 if fast else 0)

    def branch(cab):
        w0, b0 = wide(wt.conv(cab + "0"))
        w2, _ = wt.conv(cab + "2")
        pad = mid - w0.shape[0]
        return {"cab0": (F.pad(w0, (0, 0, 0, 0, 0, 0, 0, pad)).contiguous(
                    memory_format=torch.channels_last), F.pad(b0, (0, pad))),
                "cab2": (F.pad(w2, (0, 0, 0, 0, 0, pad)).contiguous(
                    memory_format=torch.channels_last), None),
                "cab2_bias": _t(t[cab + "2.bias"], device),
                "ca1": ca(cab + "3.attention.1"),
                "ca3": ca(cab + "3.attention.3")}

    layers = []
    for i, depth in enumerate(cfg["depths"]):
        blocks = []
        for j in range(depth):
            p = _BLOCK.format(i, j)
            blocks.append({**attention(p, ws, "attn."),
                           "shift": 0 if j % 2 == 0 else ws // 2,
                           **branch(p + "conv_block.cab.")})
        layers.append({"blocks": blocks,
                       "ocab": attention(_OCAB.format(i), kw, ""),
                       "conv": wide(wt.conv(f"layers.{i}.conv"))})
    return {**swinir.prepare_ends(wt, cfg, fast), "layers": layers,
            "norm_width": cw}


def _attend(qkv, blk, shift, ph, pw, fast):
    """A block's attention on its qkv rows: (F, P*Q, C) out, in rows of
    proj's input width."""
    ws, kw = blk["windows"]
    c, width = blk["widths"]
    if not fast:
        return hat_attn.hat_attn_reference(qkv, blk["table"], shift, ph, pw,
                                           ws, kw, c, width)
    if kw == ws:
        return hat_attn.sa_attn(qkv, blk["table"], shift, ph, pw, ws, c,
                                width)
    return hat_attn.oca_attn(qkv, blk["table"], ph, pw, ws, kw, c, width)


def _cab(n: torch.Tensor, blk: dict, ph: int, pw: int) -> tuple:
    """The hybrid block's convolution branch on its normed tokens ``n``:
    (z, k), z = conv(GELU(conv(n))) before the second convolution's bias,
    as (F, P*Q, C) tokens in ``n``'s type (a view of channels-last
    memory), and k = conv_scale * the channel attention's gate (F, C) f32,
    from the f32 mean of z + bias over each frame.  The add that reads
    the branch adds ``k * (z + bias)``.  Each frame's gate is computed on
    its own, so that a frame's output does not depend on the chunk it
    rides in: a mean over (F, P*Q, C) and a product of F rows sum in
    orders that depend on F."""
    z = _to_tokens(_conv(F.gelu(_conv(_to_map(n, ph, pw), blk["cab0"])),
                         blk["cab2"]))
    g = []
    for zf in z:
        m = torch.mean(zf, dim=0, keepdim=True, dtype=torch.float32) \
            + blk["cab2_bias"]
        g.append(torch.sigmoid(F.linear(F.relu(F.linear(m, *blk["ca1"])),
                                        *blk["ca3"])))
    return z, torch.cat(g) * CONV_SCALE


def _hab(t, hn: list, blk: dict, nxt, ph: int, pw: int, fast: bool, dt,
         fresh: bool, cw: int) -> torch.Tensor:
    """One hybrid attention block on the f32 stream ``t``, as SwinIR's
    `_block`: it pops its ``norm1`` from ``hn``, pushes the stream's
    ``nxt`` norm (the next block's or the OCAB's norm1) and returns the
    stream, updated in place but for the first add when ``fresh``; the
    normed copies it pushes have rows of ``cw``."""
    n = hn.pop()
    qkv = F.linear(n, *blk["qkv"])
    z, k = _cab(n, blk, ph, pw)
    del n
    o = _attend(qkv, blk, blk["shift"], ph, pw, fast)
    del qkv
    t, h = _add_norm(t, F.linear(o, *blk["proj"]), blk["norm2"], dt, fast,
                     None if fresh else t, z, k, blk["cab2_bias"])
    del o, z, k
    y = mlp(h, blk, fast)
    del h
    t, h = _add_norm(t, y, nxt, dt, fast, t, h_width=cw)
    hn.append(h)
    return t


def _ocab(t, hn: list, blk: dict, ph: int, pw: int, fast: bool, dt,
          cw: int) -> torch.Tensor:
    """The group's overlapping cross-attention block, as `_hab` with no
    branch and no shift; it pushes the stream's plain cast, which the
    group's convolution reads."""
    qkv = F.linear(hn.pop(), *blk["qkv"])
    o = _attend(qkv, blk, 0, ph, pw, fast)
    del qkv
    t, h = _add_norm(t, F.linear(o, *blk["proj"]), blk["norm2"], dt, fast,
                     t)
    del o
    y = mlp(h, blk, fast)
    del h
    t, h = _add_norm(t, y, None, dt, fast, t, h_width=cw)
    hn.append(h)
    return t


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
    layers, cw = net["layers"], net["norm_width"]
    with span("hat.embed"):
        f0, t, hn = embed(net, x, ph, pw, layers[0]["blocks"][0]["norm1"],
                          cw)
        hn = [hn]
    for i, layer in enumerate(layers):
        with span("hat.rhag"):
            r, blocks = t, layer["blocks"]
            for j, blk in enumerate(blocks):
                nxt = blocks[j + 1]["norm1"] if j + 1 < len(blocks) \
                    else layer["ocab"]["norm1"]
                t = _hab(t, hn, blk, nxt, ph, pw, fast, dt, j == 0, cw)
            with span("hat.ocab"):
                t = _ocab(t, hn, layer["ocab"], ph, pw, fast, dt, cw)
            y = _to_tokens(_conv(_to_map(hn.pop(), ph, pw), layer["conv"]))
            last = i + 1 == len(layers)
            nxt = net["norm"] if last else layers[i + 1]["blocks"][0]["norm1"]
            t, normed = _add_norm(r, y, nxt, dt, fast, r,
                                  h_width=None if last else cw)
            hn.append(normed)
            del r, y, normed
    del t
    with span("hat.upsample"):
        return upsample(net, hn.pop(), [f0], h, w, to_u8)
