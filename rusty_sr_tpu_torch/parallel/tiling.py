"""Overlap-tile inference: any image size through fixed-shape tile chunks.

The contract of `rusty_sr_tpu/parallel/tiling.py::tiled_sr` with its two
engines — "xla" (the default: the merged-conv trunk as separate conv
stages) and "fused" (the trunk as one kernel) — in the exact (f32) and
fast (bf16) tiers; of its `tiled_sr_batch`, the xla engine over a list
of images with chunks that span images (the folder and watch modes),
optionally split over the devices of a mesh's data axis; and of its
`tiled_simple`, the bilinear and downsample modes:

- The image is cut into ``tile``-sided tiles, each with a HALO-px ring
  (the trunk's receptive-field radius, 7 LR px), gathered on the host
  three ways: zero-padded (the trunk's input), edge-padded (the bilinear
  base's input, reproducing its clamp at the true border) and a {0,1}
  border mask.  The trunk multiplies every activation by the mask, so a
  tile's result equals the whole-image computation.
- uint8 images stay uint8 from the gather to the output on the xla
  engine: the tiles go to the device as u8 and come back as u8 HR tiles,
  quantised by the epilogue kernel.
- Tiles run in chunks of a fixed size (the last chunk padded), and at
  most ``_MAX_INFLIGHT`` chunks are queued on the device before the
  oldest is fetched and scattered (`_run_chunks`, one loop for every
  entry point).  On CUDA each chunk is gathered into a pinned host slot and
  copied up and back with ``non_blocking=True``, so the host gathers and
  scatters while the card computes.
"""

from __future__ import annotations

import functools
import threading
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from rusty_sr_tpu_torch.ops.activations import belu
from rusty_sr_tpu_torch.ops.color import linear_to_srgb, srgb_to_linear
from rusty_sr_tpu_torch.ops.conv import bf16_split, conv2d_same
from rusty_sr_tpu_torch.ops.cuda.conv_stage import (
    Epilogue, FusedStage, conv_stage, prepare_stage, stage_epilogue_reference)
from rusty_sr_tpu_torch.ops.cuda.shuffle import (depth_to_space_cuda,
                                                 epilogue_cuda, quantise_u8,
                                                 unpack_s2d)
from rusty_sr_tpu_torch.ops.cuda.trunk import fused_trunk, pack_trunk_weights
from rusty_sr_tpu_torch.ops.resize import avg_pool, bilinear_phases_cropped
from rusty_sr_tpu_torch.utils import native
from rusty_sr_tpu_torch.utils.profiling import span

HALO = 7

# Tiles per dispatch.  The JAX package picks the packed tier's chunk from
# a ladder measured on a TPU (`_pick_chunk`); those times do not carry
# over, so every tier here takes this fixed chunk.
_DEFAULT_CHUNK = 24

# Dispatched-but-unfetched chunks per call: each parked chunk holds its
# input and HR output on the device, so the window bounds device memory
# however large the image is.
_MAX_INFLIGHT = 8


def trunk_params(params) -> dict:
    """The merged-conv tree (`models.sr_net.merge_params`) restricted to
    the keys the trunk consumes; raw or merged trees are both accepted."""
    if "convA" not in params:
        from rusty_sr_tpu_torch.models.sr_net import merge_params
        params = merge_params(params)
    keys = ("conv0", "convA", "convB", "convC", "conv10",
            "f_bias", "f_belu", "l1_bias", "l1_belu", "l2_bias", "l2_belu",
            "l3_bias", "l3_belu", "expand_bias")
    return {k: params[k] for k in keys}


def _tile_kernel_fused(packed, zero_tiles, edge_tiles, mask_tiles,
                       factor: int, tile: int,
                       compute_dtype: torch.dtype) -> torch.Tensor:
    """(B, T+2h, T+2h, ·) tiles -> (B, f*T, f*T, 3) SR of the tile centres:
    the trunk in one kernel, then the epilogue kernel, which computes the
    LR-space bilinear base from the edge tiles and adds it in f32 before
    depth-to-space."""
    expand = fused_trunk(packed, zero_tiles, mask_tiles, factor,
                         compute_dtype)
    return epilogue_cuda(expand, factor, tile, 0, edge=edge_tiles)


# --- The xla engine's weights: 2x2 space-to-depth packing (numpy) ---

def _s2d_maps_k(k: int):
    """Index maps of an odd k x k Same conv on the 2x2 space-to-depth
    grid: 3x3 packed taps, u = 2*ap + by - fy + (c - 2) with
    c = (k - 1) // 2, clamped into the kernel, and a mask of the taps
    that exist.  Returns (uu, vv, ok), each (3, 3, 4, 4)."""
    c = (k - 1) // 2
    uu = np.zeros((3, 3, 4, 4), np.int32)
    vv = np.zeros_like(uu)
    ok = np.zeros(uu.shape, np.float32)
    for ap in range(3):
        for bp in range(3):
            for by in range(2):
                for bx in range(2):
                    for fy in range(2):
                        for fx in range(2):
                            g, ff = by * 2 + bx, fy * 2 + fx
                            u = 2 * ap + by - fy + (c - 2)
                            v = 2 * bp + bx - fx + (c - 2)
                            uu[ap, bp, g, ff] = min(max(u, 0), k - 1)
                            vv[ap, bp, g, ff] = min(max(v, 0), k - 1)
                            ok[ap, bp, g, ff] = float(
                                0 <= u < k and 0 <= v < k)
    return uu, vv, ok


def s2d_conv_weights(w: torch.Tensor, blocks) -> torch.Tensor:
    """(k, k, ci, co) -> (3, 3, 4ci, 4co) space-to-depth packed weights
    with block-major output channels: for sub-block b (widths ``blocks``,
    summing to co) the packed channel is 4*offset_b + ff*width_b + c_b,
    so every merged-stage slice is one channel range in packed space and
    per-channel vectors tile as ``v.repeat(4)``.  Each live packed tap is
    a copy of one tap: a {0,1} selection matrix applied as a float64
    product, so the gradient of a tap sums its copies' in float64, rounded
    once to the weights' type, the same on every run (the training trunk,
    `models.sr_net.sr_apply_packed`, packs inside the step).  A dead tap
    is its clamped source times 0, the JAX package's signed zero."""
    k, _, ci, co = w.shape
    if sum(blocks) != co:
        raise ValueError(f"blocks {list(blocks)} do not sum to {co}")
    sel, src, live, perm = _s2d_index(k, tuple(blocks), w.device)
    wf = w.reshape(k * k, ci * co)
    wg = torch.where(live[:, None], (sel @ wf.double()).to(w.dtype),
                     (wf[src] * 0).detach())
    wflat = wg.reshape(3, 3, 4, 4, ci, co).permute(0, 1, 2, 4, 3, 5) \
        .reshape(3, 3, 4 * ci, 4 * co)
    return wflat[..., perm].contiguous()


@functools.lru_cache(maxsize=None)
def _s2d_index(k: int, blocks: tuple, device: torch.device):
    """`s2d_conv_weights`' selection matrix (144 packed taps of the
    3x3x4x4 grid by k*k source taps, float64), each packed tap's clamped
    source and whether it is live, and the output-channel permutation,
    made once per device: a training step captured in a CUDA graph may not
    copy from the host."""
    uu, vv, ok = _s2d_maps_k(k)
    src = (uu * k + vv).reshape(-1).astype(np.int64)
    live = ok.reshape(-1) > 0
    sel = np.zeros((src.size, k * k))
    sel[np.arange(src.size), src] = live
    co = sum(blocks)
    perm = np.empty(4 * co, np.int64)
    off = 0
    for wb in blocks:
        for ff in range(4):
            for cb in range(wb):
                perm[4 * off + ff * wb + cb] = ff * co + off + cb
        off += wb
    return tuple(torch.from_numpy(a).to(device)
                 for a in (sel, src, live, perm))


def _s2d_conv_weights(w: np.ndarray, blocks) -> np.ndarray:
    """`s2d_conv_weights` on numpy arrays (float32)."""
    return s2d_conv_weights(torch.from_numpy(np.asarray(w, np.float32)),
                            blocks).numpy()


def _conv0_s2d_weights(w0: np.ndarray) -> np.ndarray:
    """(5, 5, 3, n) conv0 -> (3, 3, 12, 4n) on the 2x2 space-to-depth
    grid (`_s2d_conv_weights` with one block)."""
    return _s2d_conv_weights(w0, [np.shape(w0)[3]])


def _base_conv_weights(f: int, C: int = 3) -> np.ndarray:
    """(3, 3, C, f*f*C): the half-pixel bilinear xf upsample as a Same
    conv at LR (the phase taps span under 1 px for every factor), output
    channel (fy*f + fx)*C + c in the expand/depth-to-space order."""
    wr = np.zeros((f, 3), np.float64)
    for i in range(f):
        c0 = (i + 0.5) / f - 0.5
        lo = int(np.floor(c0))
        frac = c0 - lo
        wr[i, lo + 1] += 1.0 - frac
        wr[i, lo + 2] += frac
    W = np.zeros((3, 3, C, f * f * C), np.float32)
    for fy in range(f):
        for fx in range(f):
            for dy in range(3):
                for dx in range(3):
                    for c in range(C):
                        W[dy, dx, c, (fy * f + fx) * C + c] = \
                            wr[fy, dy] * wr[fx, dx]
    return W


_VECS = ("f_bias", "f_belu", "l1_bias", "l1_belu", "l2_bias", "l2_belu",
         "l3_bias", "l3_belu", "expand_bias")


def _np_tree(params) -> dict:
    return {k: np.asarray(torch.as_tensor(v, dtype=torch.float32))
            for k, v in trunk_params(params).items()}


def packed_trunk_params(params, factor: int = 3) -> dict:
    """Weights of `_tile_kernel_packed`, bit for bit the JAX package's
    `packed_trunk_params` with bf16: W0 (3,3,24,4n), the u8-exact conv0
    (256/255 folded in) as a two-term bf16 split over duplicated input
    channels; WA (3,3,4n,12n), WB (3,3,4n,8n+4e), WC (3,3,4n,4n+4e) in
    bf16; WD (3,3,4n+24,4e), conv10 in bf16 plus the bilinear base as the
    two-term split of its conv weights; and each bias and BeLU vector
    tiled 4x, float32.  CPU tensors."""
    p = _np_tree(params)
    n = p["f_bias"].shape[0]
    e = p["expand_bias"].shape[0]
    bf = torch.bfloat16
    w0_hi, w0_lo = bf16_split(torch.from_numpy(
        _conv0_s2d_weights(p["conv0"] * (256.0 / 255.0))))
    wd = torch.from_numpy(_s2d_conv_weights(p["conv10"], [e])).to(bf)
    wb_hi, wb_lo = bf16_split(torch.from_numpy(_s2d_conv_weights(
        _base_conv_weights(factor) * (256.0 / 255.0), [e])))
    out = {
        "W0": torch.cat([w0_hi, w0_lo], dim=2),
        "WA": torch.from_numpy(_s2d_conv_weights(p["convA"], [n, n, n]))
        .to(bf),
        "WB": torch.from_numpy(_s2d_conv_weights(p["convB"], [n, n, e]))
        .to(bf),
        "WC": torch.from_numpy(_s2d_conv_weights(p["convC"], [n, e])).to(bf),
        "WD": torch.cat([wd, wb_hi, wb_lo], dim=2),
    }
    for k in _VECS:
        out[k] = torch.from_numpy(np.tile(p[k], 4))
    return out


def flat_trunk_params(params, fast: bool) -> dict:
    """Weights of `_tile_kernel`: the merged-conv tree in float32, and for
    the fast tier (``fast``) each stage's bf16 weights beside it — convA,
    convB, convC, conv10 rounded, and conv0 in the JAX package's forms:
    ``conv0_u8`` (the u8-exact input, 256/255 folded in, two-term weight
    split over duplicated input channels), ``conv0_f32`` (three-term split
    hi*w_hi + hi*w_lo + lo*w_hi), ``conv0_s2d`` (the u8 form on the 2x2
    space-to-depth grid of an even side, `packed_trunk_params`' W0) and,
    for ``conv0_ws=False``, each of the three with its weights rounded to
    bf16 once (``conv0_u8_bf16``, ``conv0_s2d_bf16``, and
    ``conv0_f32_bf16``, the weights twice over for the image's [hi, lo]);
    their input channels are zero-padded to a multiple of 8 (the
    conv-stage kernel reads whole 16-byte channel groups; zero rows add
    nothing).  ``f_bias4``/``f_belu4`` tile conv0's vectors for the
    space-to-depth form.  CPU tensors."""
    p = {k: torch.from_numpy(v) for k, v in _np_tree(params).items()}
    if fast:
        bf = torch.bfloat16
        w0 = p["conv0"]
        u8w = w0 * (256.0 / 255.0)
        s2d = torch.from_numpy(_conv0_s2d_weights(u8w.numpy()))
        u_hi, u_lo = bf16_split(u8w)
        w_hi, w_lo = bf16_split(w0)
        s_hi, s_lo = bf16_split(s2d)
        p["conv0_u8"] = _pad_cin(torch.cat([u_hi, u_lo], dim=2), 8)
        p["conv0_f32"] = _pad_cin(torch.cat([w_hi, w_lo, w_hi], dim=2), 16)
        p["conv0_s2d"] = torch.cat([s_hi, s_lo], dim=2)
        p["conv0_u8_bf16"] = _pad_cin(u8w.to(bf), 8)
        p["conv0_f32_bf16"] = _pad_cin(torch.cat([w0, w0], dim=2).to(bf),
                                       8)
        p["conv0_s2d_bf16"] = _pad_cin(s2d.to(bf), 16)
        p["f_bias4"] = p["f_bias"].repeat(4)
        p["f_belu4"] = p["f_belu"].repeat(4)
        for k in ("convA", "convB", "convC", "conv10"):
            p[k + "_bf16"] = p[k].to(bf)
    return p


def _pad_cin(w: torch.Tensor, cin: int) -> torch.Tensor:
    """HWIO weights with zero input channels appended up to ``cin``."""
    return torch.nn.functional.pad(w, (0, 0, 0, cin - w.shape[2]))


# The conv-stage weights of each tier, packed once for the kernel.
_FLAT_STAGES = ("conv0_u8", "conv0_f32", "conv0_s2d", "conv0_u8_bf16",
                "conv0_f32_bf16", "conv0_s2d_bf16", "convA_bf16",
                "convB_bf16", "convC_bf16", "conv10_bf16")
_PACKED_STAGES = ("W0", "WA", "WB", "WC", "WD")


def prepare_stages(tree: dict) -> dict:
    """The tree with its conv-stage weights packed (`prepare_stage`) on
    their device, so that no launch repacks them."""
    return {k: prepare_stage(v) if k in _FLAT_STAGES + _PACKED_STAGES
            else v for k, v in tree.items()}


# --- The xla engine's tile kernels ---

def _tile_kernel(params, zero_tiles, edge_tiles, mask_tiles, factor: int,
                 tile: int, fast: bool = False, u8_io: bool = False,
                 out16=True, conv0_s2d: bool = True,
                 conv0_ws: bool = True) -> torch.Tensor:
    """(B, T+2h, T+2h, ·) tiles -> (B, f*T, f*T, 3) SR of the tile centres;
    ``params`` from `flat_trunk_params`.

    Exact tier (``fast`` False): every conv in f32 (TF32 off); the knobs
    change nothing.  Fast tier: every conv on the conv-stage kernel with
    bf16 operands and f32 accumulation (`_flat_fast_trunk`, which the
    knobs ``out16``, ``conv0_s2d`` and ``conv0_ws`` steer as in the JAX
    package's `_tile_kernel`).  The epilogue kernel crops the halo of
    ``expand``, adds the LR-space bilinear base, which it computes from
    the edge tiles (uint8 or f32), and with ``u8_io`` (uint8 tiles in)
    quantises, so the HR tiles come out uint8."""
    h = HALO
    p = params
    zero_u8 = zero_tiles if u8_io else None
    if u8_io and not fast:   # the exact tier's f32 convs and glue
        zero_tiles = zero_tiles.float() * (1.0 / 255.0)
        mask_tiles = mask_tiles.float()
    if fast:
        expand = _flat_fast_trunk(p, zero_tiles, zero_u8, mask_tiles, out16,
                                  conv0_s2d, conv0_ws)
    else:
        expand = _flat_exact_trunk(p, zero_tiles, mask_tiles)
    # cuDNN may hand back its convs' outputs in either memory format, and
    # the sum follows it; the epilogue kernel reads NHWC densely.
    return epilogue_cuda(expand.contiguous(), factor, tile, h,
                         edge=edge_tiles, edge_offset=h, to_u8=u8_io)


def _flat_exact_trunk(p, x, mask):
    """The exact tier's trunk: f32 convs (TF32 off) and f32 glue."""
    n = p["f_bias"].shape[0]
    e = p["expand_bias"].shape[0]
    f_ = mask * belu(conv2d_same(x, p["conv0"]) + p["f_bias"], p["f_belu"])
    a = conv2d_same(f_, p["convA"])                      # conv1|conv2|conv3
    l1 = mask * belu(a[..., :n] + p["l1_bias"], p["l1_belu"])
    b = conv2d_same(l1, p["convB"])                      # conv5|conv6|conv7
    l2 = mask * belu(a[..., n:2 * n] + b[..., :n] + p["l2_bias"],
                     p["l2_belu"])
    c = conv2d_same(l2, p["convC"])                      # conv8|conv9
    l3 = mask * belu(a[..., 2 * n:3 * n] + b[..., n:2 * n] + c[..., :n]
                     + p["l3_bias"], p["l3_belu"])
    return (b[..., 2 * n:2 * n + e] + c[..., n:n + e]
            + conv2d_same(l3, p["conv10"]) + p["expand_bias"])


def _pad_to(t: torch.Tensor, c: int) -> torch.Tensor:
    """``t`` with zero channels appended up to ``c``."""
    return torch.cat([t, t.new_zeros(*t.shape[:3], c - t.shape[3])], dim=-1)


def _glue(cur, addends, p, name: str, m) -> torch.Tensor:
    """A stage's glue as plain ops, for stage outputs that the fused
    epilogue does not take (f32 addends): the bf16 activation
    ``belu(((add0 + add1) + cur) + bias) * m`` of `Epilogue`, by its plain
    version."""
    n = cur.shape[-1]
    return stage_epilogue_reference(cur, Epilogue(
        n, p[name + "_bias"], p[name + "_belu"], tuple(addends), m),
        cur.new_empty(*cur.shape[:3], n, dtype=torch.bfloat16))


def _conv0_fast(p, x, zero_u8, mask, m, s2d: bool, ws: bool):
    """conv0 of the flat fast tier, as the JAX package's `_tile_kernel`
    takes it: the masked bf16 activation (B, S, S, n).  On uint8 tiles of
    an even side (``s2d``) it runs in 2x2 space-to-depth space, its bias,
    BeLU and mask there too, then unpacks; on other uint8 tiles it reads
    the u8-exact input k/256; on f32 tiles the two-term split of the
    image.  ``ws`` splits the weights in two bf16 terms; without it they
    are rounded once (the f32 input then takes conv(hi) + conv(lo), one
    stage over [hi, lo] and the weights twice over)."""
    bf, f32 = torch.bfloat16, torch.float32
    n = p["f_bias"].shape[0]
    if zero_u8 is not None and s2d:
        t8 = _pack_s2d(zero_u8).to(bf) * 2.0 ** -8
        x0 = torch.cat([t8, t8], dim=-1) if ws else _pad_to(t8, 16)
        w0 = p["conv0_s2d" if ws else "conv0_s2d_bf16"]
        f4 = conv_stage(x0, FusedStage(w0, Epilogue(
            4 * n, p["f_bias4"], p["f_belu4"], (), _pack_s2d(mask).to(bf))),
            f32)
        return unpack_s2d(f4)
    epi = Epilogue(n, p["f_bias"], p["f_belu"], (), m)
    if zero_u8 is not None:
        t8 = zero_u8.to(bf) * 2.0 ** -8
        x0 = torch.cat([t8, t8], dim=-1) if ws else t8
        return conv_stage(_pad_to(x0, 8), FusedStage(
            p["conv0_u8" if ws else "conv0_u8_bf16"], epi), f32)
    hi, lo = bf16_split(x)
    if ws:
        return conv_stage(_pad_to(torch.cat([hi, hi, lo], dim=-1), 16),
                          FusedStage(p["conv0_f32"], epi), f32)
    return conv_stage(_pad_to(torch.cat([hi, lo], dim=-1), 8),
                      FusedStage(p["conv0_f32_bf16"], epi), f32)


def _flat_fast_trunk(p, x, zero_u8, mask, out16=True, conv0_s2d: bool = True,
                     conv0_ws: bool = True):
    """The flat fast tier's trunk: conv0 (`_conv0_fast`) then four conv
    stages.  ``out16`` True (the default) rounds every stage output to
    bf16 and fuses the glue into each stage (`Epilogue`): each stage's
    activation is written into the first channels of its output, which
    the next stage reads in place, and the BeLUs and the final sum read
    the rounded outputs back in f32.  ``out16`` False keeps every stage
    output f32, and "bcd" keeps convA's f32 and rounds the 3x3 stages';
    the fused epilogue takes bf16 addends only, so a stage that sums an
    f32 output runs unfused, its glue as plain ops (`_glue`)."""
    bf, f32 = torch.bfloat16, torch.float32
    n = p["f_bias"].shape[0]
    e = p["expand_bias"].shape[0]
    even = zero_u8 is not None and zero_u8.shape[1] % 2 == 0 \
        and zero_u8.shape[2] % 2 == 0
    m = mask.to(bf)
    f_ = _conv0_fast(p, x, zero_u8, mask, m, conv0_s2d and even, conv0_ws)

    def act(w, name, addends=()):
        return FusedStage(w, Epilogue(n, p[name + "_bias"], p[name + "_belu"],
                                      addends, m))

    def last(l3, b, c):             # conv10 + the sum, rounded addends
        return conv_stage(l3, FusedStage(p["conv10_bf16"], Epilogue(
            e, p["expand_bias"], addends=(b[..., 2 * n:], c[..., n:]),
            act_dtype=f32)), bf)

    if out16 is True:
        a = conv_stage(f_, act(p["convA_bf16"], "l1"), bf)  # l1|conv2|conv3
        b = conv_stage(a[..., :n], act(p["convB_bf16"], "l2", (a[..., n:],)),
                       bf)                                  # l2|conv6|conv7
        c = conv_stage(b[..., :n], act(p["convC_bf16"], "l3",
                                       (a[..., 2 * n:], b[..., n:])), bf)
        return last(c[..., :n], b, c)

    def cv(t, name):
        return conv_stage(t, p[name + "_bf16"],
                          bf if out16 == "bcd" and name != "convA" else f32)

    a = cv(f_, "convA")
    l1 = _glue(a[..., :n], (), p, "l1", m)
    b = cv(l1, "convB")
    l2 = _glue(b[..., :n], (a[..., n:2 * n],), p, "l2", m)
    c = cv(l2, "convC")
    l3 = _glue(c[..., :n], (a[..., 2 * n:3 * n], b[..., n:2 * n]), p, "l3",
               m)
    if out16 == "bcd":
        return last(l3, b, c)
    return ((b[..., 2 * n:2 * n + e] + c[..., n:n + e]) + cv(l3, "conv10")) \
        + p["expand_bias"]


def _pack_s2d(t: torch.Tensor) -> torch.Tensor:
    """(B, S, S, C) -> (B, S/2, S/2, 4C), block-major (inverse of
    `ops.cuda.shuffle.unpack_s2d`)."""
    nb, sh, sw, c = t.shape
    return t.reshape(nb, sh // 2, 2, sw // 2, 2, c) \
        .permute(0, 1, 3, 2, 4, 5).reshape(nb, sh // 2, sw // 2, 4 * c)


def _tile_kernel_packed(pp, zero_tiles, edge_tiles, mask_tiles, factor: int,
                        tile: int) -> torch.Tensor:
    """(B, T+2h, T+2h, ·) uint8 tiles with an even side -> (B, f*T, f*T, 3)
    uint8: the fast tier with the whole trunk in 2x2 space-to-depth space
    (quarter resolution, 4x channels); ``pp`` from `packed_trunk_params`.

    Five 3x3 stages on the conv-stage kernel, each with its glue fused
    (`Epilogue`): W0 (the split u8-exact conv0, f32 sums) and WA, WB, WC
    (bf16 outputs) each write their BeLU activation, rounded to bf16 and
    masked, into their first 4n channels, which the next stage reads in
    place; WD (conv10 plus the bilinear base as extra K rows over the
    packed edge tiles) writes the sum ((b + c) + d) + bias in f32, in
    packed space.  WC leaves a gap of 24 channels after l3 for the packed
    edge tiles, so that WD's input [l3, te8, te8] is a prefix of its
    output.  The epilogue kernel quantises the sum, unpacks, crops the
    halo and shuffles.

    ``zero_tiles=None`` derives the zero-padded tiles on the device as
    edge * mask, which is the same bytes: the two gathers differ only
    outside the image, where the mask is 0."""
    h = HALO
    bf = torch.bfloat16
    ci = edge_tiles.shape[-1]
    N = pp["f_bias"].shape[0]
    E = pp["expand_bias"].shape[0]
    te8 = _pack_s2d(edge_tiles).to(bf) * 2.0 ** -8
    m4 = _pack_s2d(mask_tiles).to(bf)
    if zero_tiles is None:
        t8 = te8 * m4.repeat_interleave(ci, dim=-1)
    else:
        t8 = _pack_s2d(zero_tiles).to(bf) * 2.0 ** -8

    def act(w, name, addends=(), gap=0):
        return FusedStage(pp[w], Epilogue(N, pp[name + "_bias"],
                                          pp[name + "_belu"], addends, m4,
                                          gap=gap))

    gap = 2 * te8.shape[-1]
    f_ = conv_stage(torch.cat([t8, t8], dim=-1), act("W0", "f"),
                    torch.float32)
    a = conv_stage(f_, act("WA", "l1"), bf)
    b = conv_stage(a[..., :N], act("WB", "l2", (a[..., N:],)), bf)
    c = conv_stage(b[..., :N], act("WC", "l3", (a[..., 2 * N:], b[..., N:]),
                                   gap), bf)
    c[..., N:N + gap // 2] = te8
    c[..., N + gap // 2:N + gap] = te8
    total = conv_stage(c[..., :N + gap], FusedStage(pp["WD"], Epilogue(
        E, pp["expand_bias"], addends=(b[..., 2 * N:], c[..., N + gap:]),
        act_dtype=torch.float32)), torch.float32)
    return epilogue_cuda(total, factor, tile, h, to_u8=True, packed=True)


def _tile_kernel_q8(q, zero_tiles, edge_tiles, mask_tiles, factor: int,
                    tile: int, u8_io: bool = False) -> torch.Tensor:
    """The int8 engine's tile kernel (`models.quant.q8_expand`, ``q`` from
    `_int8_trunk`): the tiling and mask of `_tile_kernel`, the trunk's
    three merged stages on int8 products, then the epilogue kernel (the
    base from the edge tiles, the quantisation to u8 with ``u8_io``)."""
    from rusty_sr_tpu_torch.models.quant import q8_expand
    h = HALO
    if u8_io:
        zero_tiles = zero_tiles.float() * (1.0 / 255.0)
    expand = q8_expand(q, zero_tiles, factor, mask=mask_tiles.float())
    return epilogue_cuda(expand.contiguous(), factor, tile, h,
                         edge=edge_tiles, edge_offset=h, to_u8=u8_io)


def _int8_trunk(mparams, sample: np.ndarray, u8_io: bool, device,
                cache: Optional[dict] = None) -> dict:
    """The calibrated int8 trunk on ``device`` from ``sample``, zero-padded
    tiles taken evenly across the image (one exact f32 pass,
    `models.quant`); first-chunk-only sampling under-covers large images.
    ``cache``: a dict the caller keeps, so that a resident process
    calibrates once and then keeps the ranges."""
    if cache is not None and "q" in cache:
        return cache["q"]
    from rusty_sr_tpu_torch.models.quant import (calibrate_act_scales,
                                                 prepare_q8, quantize_trunk)
    if u8_io:
        sample = sample.astype(np.float32) / 255.0
    m = {k: torch.as_tensor(v, dtype=torch.float32).to(device)
         for k, v in mparams.items()}
    q = prepare_q8(quantize_trunk(m, calibrate_act_scales(
        m, torch.from_numpy(np.ascontiguousarray(sample)).to(device))))
    if cache is not None:
        cache["q"] = q
    return q


# --- The chunk pipeline shared by every tile entry point ---

# Pinned host slots: one ring per lane, a (device, place in the mesh)
# pair, so that two replicas on one card keep apart.  A ring is a list of
# `_Slot`s for one (input specs, output spec), replaced when a call needs
# another shape, so that the pinned memory kept is one ring a lane.  A
# ring is taken out of the dict while a call uses it, so that two
# concurrent calls never share one.
_RINGS: dict = {}          # (device, lane) -> (specs, [_Slot, ...])
_RINGS_LOCK = threading.Lock()


class _Slot:
    """One chunk's pinned host buffers — the kernel inputs it gathers into
    and the result it copies back into — and the events that guard them:
    the inputs are gathered again only after ``uploaded`` (the upload
    has read them), the result is scattered only after ``fetched``."""

    def __init__(self, in_specs, out_spec):
        self.ins = [None if s is None else
                    torch.empty(s[0], dtype=s[1], pin_memory=True)
                    for s in in_specs]
        self.out = torch.empty(out_spec[0], dtype=out_spec[1],
                               pin_memory=True)
        self.uploaded = torch.cuda.Event()
        self.fetched = torch.cuda.Event()


def _run_chunks(devices, n_tiles: int, chunk: int, in_specs, out_spec,
                gather, runs, scatter) -> None:
    """Tiles [0, n_tiles) through the tile kernel in chunks of ``chunk``
    tiles (the last one padded with zero tiles, so every chunk has one
    shape), chunk j on ``devices[j % n]`` through ``runs[j % n]`` (that
    device's kernel, with its weights there), at most ``_MAX_INFLIGHT``
    chunks a device queued before the oldest is fetched.

    With n devices (a mesh's data axis), chunks n*k .. n*k + n-1 are one
    step split evenly over them, as the JAX package shards a chunk of
    n * ``chunk`` tiles; the last step is padded with chunks of zero
    tiles, whose results are dropped, so that every device gets one.
    Results are scattered in global tile order.

    ``in_specs``: per input of a run, (chunk shape, dtype) or None for
    an input it is given as None; ``out_spec`` the same for its result.
    ``gather(g0, g1, bufs)`` writes tiles [g0, g1) into the first g1-g0
    tiles of ``bufs`` (numpy arrays, None where the spec is None);
    ``scatter(g0, res)`` takes their results as a numpy array.

    On CUDA each chunk is gathered straight into a pinned slot of its
    lane's ring of ``_MAX_INFLIGHT + 1`` (kept until a call needs another
    shape), copied up on the lane's upload stream and its result copied
    down on its download stream, both ``non_blocking=True``, so the next
    chunk's upload and the previous one's download overlap this chunk's
    kernels; the slot's events order the host's reuse of it after those
    copies.  On the CPU every chunk gets fresh arrays and runs in order.

    Each chunk's stages are `span`s (``rusty_sr.chunk.*``): ``pin`` (a
    new pinned slot), ``slot_wait`` (the host waits for a slot's copies),
    ``gather`` (with the zero fill of unused rows), ``launch`` (upload,
    kernels and download enqueued; on the CPU the run), ``fetch_wait``
    (the host waits for a result's download) and ``scatter``."""
    n_dev = len(devices)
    n_chunks = -(-n_tiles // chunk)
    n_chunks += -n_chunks % n_dev
    pending: deque = deque()

    def drain_one():
        g0, cnt, res = pending.popleft()
        if isinstance(res, _Slot):
            with span("chunk.fetch_wait"):
                res.fetched.synchronize()
            res = res.out[:cnt]
        if cnt:
            with span("chunk.scatter"):
                scatter(g0, res[:cnt].numpy())

    def tile_range(j):
        g0 = min(j * chunk, n_tiles)
        return g0, min(g0 + chunk, n_tiles)

    if devices[0].type != "cuda":
        for j in range(n_chunks):
            g0, g1 = tile_range(j)
            with span("chunk.gather"):
                ins = [None if s is None else torch.zeros(s[0], dtype=s[1])
                       for s in in_specs]
                if g1 > g0:
                    gather(g0, g1, [None if t is None else t.numpy()
                                    for t in ins])
            with span("chunk.launch"):
                res = runs[j % n_dev](*ins)
            pending.append((g0, g1 - g0, res))
            if len(pending) >= _MAX_INFLIGHT * n_dev:
                drain_one()
        while pending:
            drain_one()
        return

    specs = (tuple(in_specs), out_spec)
    lanes = list(enumerate(devices))
    with _RINGS_LOCK:
        kept = [_RINGS.pop((d, i), (None, [])) for i, d in lanes]
    rings = [ring if have == specs else [] for have, ring in kept]
    try:
        n_slots = _MAX_INFLIGHT + 1
        streams = [(torch.cuda.current_stream(d), torch.cuda.Stream(d),
                    torch.cuda.Stream(d)) for d in devices]
        for j in range(n_chunks):
            g0, g1 = tile_range(j)
            lane, k = j % n_dev, j // n_dev
            device, ring = devices[lane], rings[lane]
            compute, up, down = streams[lane]
            if len(ring) <= k % n_slots:
                with span("chunk.pin"):
                    ring.append(_Slot(in_specs, out_spec))
            slot = ring[k % n_slots]
            with span("chunk.slot_wait"):
                slot.uploaded.synchronize()
                slot.fetched.synchronize()
            with span("chunk.gather"):
                bufs = [None if t is None else t.numpy() for t in slot.ins]
                if g1 > g0:
                    gather(g0, g1, bufs)
                for b in bufs:
                    if b is not None:
                        b[g1 - g0:] = 0
            with span("chunk.launch"), torch.cuda.device(device):
                with torch.cuda.stream(up):
                    ins = [None if t is None else
                           t.to(device, non_blocking=True) for t in slot.ins]
                    slot.uploaded.record(up)
                compute.wait_event(slot.uploaded)
                for t in ins:
                    if t is not None:
                        t.record_stream(compute)
                res = runs[lane](*ins)
                down.wait_stream(compute)
                res.record_stream(down)
                with torch.cuda.stream(down):
                    slot.out[:g1 - g0].copy_(res[:g1 - g0],
                                             non_blocking=True)
                    slot.fetched.record(down)
            pending.append((g0, g1 - g0, slot))
            if len(pending) >= _MAX_INFLIGHT * n_dev:
                drain_one()
        while pending:
            drain_one()
    finally:
        with _RINGS_LOCK:
            for (i, d), ring in zip(lanes, rings):
                _RINGS[(d, i)] = (specs, ring)


def _check_tier(compute_dtype) -> bool:
    """True for the fast tier (bfloat16), False for the exact one."""
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, not "
                         f"{compute_dtype}")
    return compute_dtype == torch.bfloat16


def _xla_runner(params, factor: int, tile: int, fast: bool, u8_io: bool,
                device: torch.device, trunk: str = "auto", out16=True,
                conv0_s2d: bool = True, conv0_ws: bool = True):
    """The xla engine's tile kernel with its weights on ``device``:
    (run, use_packed).  The packed tier takes the fast tier on uint8
    tiles of an even padded side unless ``trunk`` is "flat"; the flat
    tile kernel takes the rest, steered by the knobs."""
    use_packed = fast and u8_io and trunk != "flat" \
        and (tile + 2 * HALO) % 2 == 0
    if use_packed:
        pp = prepare_stages({k: v.to(device) for k, v in
                             packed_trunk_params(params, factor).items()})
        return (lambda z, e, m: _tile_kernel_packed(pp, z, e, m, factor,
                                                    tile)), True
    fp = prepare_stages({k: v.to(device) for k, v in
                         flat_trunk_params(params, fast).items()})
    return (lambda z, e, m: _tile_kernel(fp, z, e, m, factor, tile, fast,
                                         u8_io, out16, conv0_s2d,
                                         conv0_ws)), False


def _resolve_out16(out16, fast: bool):
    """JAX's resolution of ``out16``: None is True in the fast tier and
    False in the exact tier; other values are True, False or "bcd"."""
    if out16 is None:
        return fast
    if out16 not in (True, False, "bcd"):
        raise ValueError(f"out16 must be None, True, False or 'bcd', not "
                         f"{out16!r}")
    return out16


def _tile_specs(chunk: int, tile: int, factor: int, u8_io: bool,
                need_zero: bool):
    """The chunk pipeline's specs of the neural tile kernels: zero-padded
    tiles (or None), edge-padded tiles, masks; the HR tiles out."""
    side = tile + 2 * HALO
    dt = torch.uint8 if u8_io else torch.float32
    tf = tile * factor
    return ([((chunk, side, side, 3), dt) if need_zero else None,
             ((chunk, side, side, 3), dt), ((chunk, side, side, 1), dt)],
            ((chunk, tf, tf, 3), dt))


def tiled_sr(params, image: np.ndarray, factor: int = 3, *, tile: int = 242,
             chunk: Optional[int] = None, engine: str = "xla",
             compute_dtype: Optional[torch.dtype] = None, out16=None,
             conv0_s2d: bool = True, conv0_ws: bool = True,
             trunk: str = "auto", rh: int = 16, packed=None,
             device="cuda") -> np.ndarray:
    """Upscale an (H,W,3) image by ``factor``, any size: uint8 in gives
    uint8 out on the xla and int8 engines; float32 in [0,1] gives float32
    out.

    ``tile`` is the LR tile side (tile + 2*HALO is the padded side; 242
    gives 256).  ``chunk`` is the number of tiles per dispatch (24).
    ``engine``: "xla" (the default; `_tile_kernel`, or
    `_tile_kernel_packed` for the fast tier on uint8 tiles of an even
    padded side), "fused" (the trunk kernel; float32 images only) or
    "int8" (`_tile_kernel_q8`: the trunk's merged stages on int8 products,
    calibrated on tiles taken evenly across the image).
    ``compute_dtype`` None (or float32) is the exact tier; bfloat16 the
    fast tier.

    The JAX package's variant knobs, which change only the xla engine's
    fast tier: ``trunk="flat"`` takes the flat tile kernel where "auto"
    takes the packed one; on the flat kernel ``out16`` (None: True) rounds
    every stage output to bf16, False none, "bcd" all but convA's;
    ``conv0_s2d`` runs conv0 of uint8 tiles of an even side in 2x2
    space-to-depth space; ``conv0_ws`` splits conv0's weights in two bf16
    terms (False: rounded once).  ``packed``: the fused engine's weights
    from `ops.cuda.trunk.pack_trunk_weights`, so that a caller does not
    pack them for every image.  ``rh`` is the Pallas kernel's row block,
    validated as there (a divisor of the tile is chosen) and otherwise
    unused: the CUDA kernels have no row block.
    ``device`` runs the tiles there: "cuda" launches the kernels, "cpu"
    runs their plain PyTorch versions."""
    if engine not in ("xla", "fused", "int8"):
        raise ValueError(f"engine must be 'xla', 'fused' or 'int8', not "
                         f"{engine!r}")
    if trunk not in ("auto", "flat"):
        raise ValueError(f"trunk must be 'auto' or 'flat', not {trunk!r}")
    fast = _check_tier(compute_dtype)
    out16 = _resolve_out16(out16, fast)
    u8_io = np.asarray(image).dtype == np.uint8
    img = np.asarray(image) if u8_io else np.asarray(image, np.float32)
    if engine == "fused" and u8_io:
        raise ValueError("the fused engine takes f32 images in [0,1]; "
                         "divide uint8 pixels by 255")
    if tile < 1:
        raise ValueError(f"tile must be positive, got {tile}")
    device = torch.device(device)
    chunk = _DEFAULT_CHUNK if chunk is None else chunk
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    hgt, wid, _ = img.shape
    h = HALO
    ny = max(1, -(-hgt // tile))
    nx = max(1, -(-wid // tile))

    use_packed = False
    with span("tiled.prepare"):
        if engine == "fused":
            if rh < 1:
                raise ValueError(f"rh must be positive, got {rh}")
            rh = next(d for d in range(rh, 0, -1) if tile % d == 0)
            cd = compute_dtype or torch.float32
            if packed is None:
                packed = pack_trunk_weights(trunk_params(params), factor, cd)
            packed = {k: v.to(device) for k, v in packed.items()}
            run = lambda z, e, m: _tile_kernel_fused(  # noqa: E731
                packed, z, e, m, factor, tile, cd)
        elif engine == "int8":
            # Calibration tiles taken evenly across the whole image,
            # gathered one at a time.
            idx = np.unique(np.linspace(0, ny * nx - 1,
                                        min(chunk, ny * nx)).astype(int))
            sample = np.concatenate([native.gather_tiles_range(
                img, tile, h, nx, i, i + 1)[0] for i in idx])
            q = _int8_trunk(trunk_params(params), sample, u8_io, device)
            run = lambda z, e, m: _tile_kernel_q8(  # noqa: E731
                q, z, e, m, factor, tile, u8_io)
        else:
            run, use_packed = _xla_runner(params, factor, tile, fast, u8_io,
                                          device, trunk, out16, conv0_s2d,
                                          conv0_ws)

    with span("tiled.outputs"):     # the grid covers every pixel
        out = np.empty((hgt * factor, wid * factor, 3),
                       np.uint8 if u8_io else np.float32)
    in_specs, out_spec = _tile_specs(chunk, tile, factor, u8_io,
                                     not use_packed)
    _run_chunks(
        [device], ny * nx, chunk, in_specs, out_spec,
        lambda g0, g1, bufs: native.gather_tiles_range(
            img, tile, h, nx, g0, g1, need_zero=not use_packed, out=bufs),
        [run], lambda g0, res: native.scatter_tiles(res, g0, nx, out))
    return out


def tiled_sr_batch(params, images, factor: int = 3, *, tile: int = 242,
                   chunk: Optional[int] = None,
                   compute_dtype: Optional[torch.dtype] = None, out16=None,
                   mesh=None,
                   on_image_done: Optional[Callable] = None,
                   release_outputs: bool = False, device="cuda") -> list:
    """Upscale a list of (H,W,3) images on the xla engine, with chunks of
    tiles that span images, so that a folder of small images fills whole
    chunks.  All images share one dtype (uint8 in gives uint8 out; float
    in [0,1] gives float32 out), or ``ValueError``.  Returns the outputs
    in input order.

    The tier is `tiled_sr`'s: exact for ``compute_dtype`` None, fast for
    bfloat16 (the packed tier on uint8 tiles of an even padded side, the
    flat tier otherwise, with `tiled_sr`'s ``out16``).  The int8 engine is
    `tiled_sr`'s alone, as in the JAX package.  ``on_image_done(i,
    out)`` is called on the caller's thread, in ascending ``i``, once the
    chunk that holds image i's last tile is scattered, while later chunks
    still compute: a caller that encodes there overlaps the host with the
    card, and one that blocks holds the chunk loop back.
    ``release_outputs=True`` drops this function's reference after the
    callback, so that slot of the returned list is None.

    ``mesh`` (`parallel.mesh.make_mesh`) runs the tiles on its data
    axis's devices (``mesh.lanes``, one per data index: the JAX package
    replicates each chunk over the spatial and model axes, which computes
    the same bytes) in place of ``device``: each step of ``chunk`` tiles a
    device is split
    evenly over them (``chunk`` counts tiles per device, as in the JAX
    package), each device with its own copy of the weights, its own
    pinned slots and copy streams, and its own in-flight window.  A
    tile's result does not depend on the device that ran it, so the
    outputs are the single-device path's."""
    fast = _check_tier(compute_dtype)
    out16 = _resolve_out16(out16, fast)
    if not images:
        return []
    imgs = [np.asarray(im) for im in images]
    u8_io = imgs[0].dtype == np.uint8
    if not all((im.dtype == np.uint8) == u8_io for im in imgs):
        raise ValueError("all images in a batch must share the input "
                         "dtype (uint8 or float)")
    if not u8_io:
        imgs = [np.asarray(im, np.float32) for im in imgs]
    if tile < 1:
        raise ValueError(f"tile must be positive, got {tile}")
    devices = [torch.device(device)] if mesh is None else list(mesh.lanes)
    chunk = _DEFAULT_CHUNK if chunk is None else chunk
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    h = HALO
    metas = [(max(1, -(-im.shape[0] // tile)), max(1, -(-im.shape[1] // tile)))
             for im in imgs]                         # (ny, nx) per image
    starts = np.cumsum([0] + [ny * nx for ny, nx in metas])
    with span("tiled.prepare"):
        runners = [_xla_runner(params, factor, tile, fast, u8_io, d,
                               out16=out16) for d in devices]
    use_packed = runners[0][1]

    def gather_range(g0: int, g1: int, bufs) -> None:
        # Walk the images that the global tile range [g0, g1) meets and
        # gather each one's image-local sub-range in place.
        i = int(np.searchsorted(starts, g0, side="right")) - 1
        pos = 0
        while g0 < g1:
            lo = g0 - int(starts[i])
            hi = min(g1, int(starts[i + 1])) - int(starts[i])
            native.gather_tiles_range(
                imgs[i], tile, h, metas[i][1], lo, hi,
                need_zero=not use_packed,
                out=[None if b is None else b[pos:pos + hi - lo]
                     for b in bufs])
            pos += hi - lo
            g0 = int(starts[i + 1])
            i += 1

    with span("tiled.outputs"):     # the grids cover every pixel
        outs = [np.empty((im.shape[0] * factor, im.shape[1] * factor, 3),
                         np.uint8 if u8_io else np.float32) for im in imgs]
    remain = [ny * nx for ny, nx in metas]     # undrained tiles per image
    cursor = [0]                               # the image the drain is in
    in_specs, out_spec = _tile_specs(chunk, tile, factor, u8_io,
                                     not use_packed)
    _run_chunks(devices, int(starts[-1]), chunk, in_specs, out_spec,
                gather_range, [run for run, _ in runners],
                lambda g0, res: _drain_batch_chunk(
                    res, g0, starts, metas, outs, cursor, remain,
                    on_image_done, release_outputs))
    return outs


def _drain_batch_chunk(res: np.ndarray, g0: int, starts, metas, outs,
                       cursor: list, remain: list, on_image_done=None,
                       release_outputs: bool = False) -> None:
    """Scatter one fetched chunk, the results of global tiles [g0, g0 +
    len(res)), across the images it spans, in one `native.scatter_runs`
    call (chunks are contiguous in the global tile order; ``cursor``
    carries the image index from one call to the next).  Then
    ``on_image_done`` fires, in ascending order, for each image whose
    undrained count in ``remain`` the chunk brought to 0."""
    cnt, j = res.shape[0], 0
    runs, done = [], []
    while j < cnt:            # one contiguous run of tiles per image
        g = g0 + j
        while g >= starts[cursor[0] + 1]:
            cursor[0] += 1
        idx = cursor[0]
        run_len = min(cnt - j, int(starts[idx + 1]) - g)
        runs.append((j, run_len, g - int(starts[idx]), metas[idx][1],
                     outs[idx]))
        j += run_len
        remain[idx] -= run_len
        if remain[idx] == 0:
            done.append(idx)
    native.scatter_runs(res, runs)
    if on_image_done is None:
        return
    for idx in done:
        with span("batch.on_image_done"):
            on_image_done(idx, outs[idx])
        if release_outputs:
            outs[idx] = None


def _tile_kernel_simple(edge_tiles: torch.Tensor, factor: int, tile: int,
                        mode: str, u8_io: bool) -> torch.Tensor:
    """Tile kernel for the non-neural modes, on edge-padded tiles.

    ``bilinear``: sRGB->linear -> half-pixel clamped bilinear xf ->
    linear->sRGB, the phases rearranged by the depth-to-space kernel (u8
    I/O quantises the phases first: quantisation is elementwise, so the
    order is JAX's result, and the kernel moves a quarter of the bytes).
    ``downsample``: sRGB->linear -> fxf mean pool -> linear->sRGB, on the
    tile's core (tile % factor == 0)."""
    h = HALO
    x = edge_tiles.float() * (1.0 / 255.0) if u8_io else edge_tiles
    if mode == "bilinear":
        ph = linear_to_srgb(bilinear_phases_cropped(srgb_to_linear(x),
                                                    factor, h, h, tile))
        return depth_to_space_cuda(quantise_u8(ph) if u8_io else ph, factor)
    core = x[:, h:h + tile, h:h + tile, :]
    out = linear_to_srgb(avg_pool(srgb_to_linear(core), factor))
    return quantise_u8(out) if u8_io else out


def _gather_edge(img: np.ndarray, tile: int, h: int, ny: int, nx: int):
    """Edge-padded tiles over the whole grid, any dtype (the bilinear and
    downsample kernels use neither zero-padded tiles nor masks)."""
    hgt, wid, ch = img.shape
    pad = ((h, h + ny * tile - hgt), (h, h + nx * tile - wid), (0, 0))
    edge_img = np.pad(img, pad, mode="edge")
    side = tile + 2 * h
    et = np.empty((ny * nx, side, side, ch), img.dtype)
    for k in range(ny * nx):
        y0, x0 = (k // nx) * tile, (k % nx) * tile
        et[k] = edge_img[y0:y0 + side, x0:x0 + side]
    return et


def tiled_simple(image: np.ndarray, factor: int = 3, *, mode: str,
                 tile: int = 240, chunk: Optional[int] = None,
                 device="cuda") -> np.ndarray:
    """Overlap-tile loop for the bilinear and downsample modes: any image
    size through one tile shape.  uint8 in gives uint8 out; float in
    gives float out.  For ``downsample`` the image must already be
    cropped to a multiple of ``factor`` (the CLI does so)."""
    if mode not in ("bilinear", "downsample"):
        raise ValueError(f"mode must be 'bilinear' or 'downsample', not "
                         f"{mode!r}")
    if mode == "downsample":
        tile -= tile % factor
    if tile < 1:
        raise ValueError(f"tile must be positive, got {tile}")
    u8_io = np.asarray(image).dtype == np.uint8
    img = np.asarray(image) if u8_io else np.asarray(image, np.float32)
    device = torch.device(device)
    chunk = _DEFAULT_CHUNK if chunk is None else chunk
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    hgt, wid, _ = img.shape
    h = HALO
    ny = max(1, -(-hgt // tile))
    nx = max(1, -(-wid // tile))
    et = _gather_edge(img, tile, h, ny, nx)
    side = tile + 2 * h
    up = mode == "bilinear"
    tf = tile * factor if up else tile // factor
    oh, ow = (hgt * factor, wid * factor) if up else (hgt // factor,
                                                     wid // factor)
    dt = torch.uint8 if u8_io else torch.float32
    # The grid covers every pixel (the tile is a multiple of ``factor``).
    out = np.empty((oh, ow, 3), np.uint8 if u8_io else np.float32)

    def gather(g0, g1, bufs):
        bufs[0][:g1 - g0] = et[g0:g1]

    _run_chunks([device], ny * nx, chunk, [((chunk, side, side, 3), dt)],
                ((chunk, tf, tf, 3), dt), gather,
                [lambda e: _tile_kernel_simple(e, factor, tile, mode,
                                               u8_io)],
                lambda g0, res: native.scatter_tiles(res, g0, nx, out))
    return out
