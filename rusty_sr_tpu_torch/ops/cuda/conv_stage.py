"""One trunk conv stage with bf16 operands and f32 accumulation, and the
fast tiers' BeLU/mask/sum glue as its optional epilogue.

The contract of `rusty_sr_tpu/ops/conv.py::_conv_native` with bf16
operands and ``preferred_element_type=f32``, as the xla engine's fast
tiers call it (`parallel/tiling.py`): a stride-1 cross-correlation with
Same zero padding, NHWC bf16 input, HWIO bf16 weights of odd size, f32
accumulation, and an f32 output or one rounded to nearest-even bf16 (the
JAX code's ``cv(...).astype(bf16)``).  With an `Epilogue`, the glue that
follows the conv in the tile kernels runs on the conv's output channels
``[0, n_act)`` (`stage_epilogue_reference` says how), and the others are
written as the plain conv writes them, ``gap`` channels further on.

`conv_stage` runs the hand-written CUDA kernel `csrc/conv_stage.cu` (the
counterpart of the Pallas conv-stage probes `scripts/mosaic_probe*.py`)
on CUDA tensors, and `conv_stage_reference` on CPU tensors; on any other
device, or on a build or launch failure, it raises.  `LAUNCHES` counts the
kernel's launches, `SHAPE_LAUNCHES` by stage shape.  `prepare_stage`
packs HWIO weights once into the kernel's operand image; plain HWIO
weights are packed on every call.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from rusty_sr_tpu_torch.ops.activations import belu
from rusty_sr_tpu_torch.ops.conv import exact_f32

# Launches of the CUDA kernel since the count was last set to 0, in all
# and by stage shape (k, Cin, Cout).
LAUNCHES = 0
SHAPE_LAUNCHES: dict = {}

_OUT = (torch.float32, torch.bfloat16)
# The kernel's N tile widths (output channels per block; csrc/
# hopper.cuh); wider stages are split over N blocks.
_WIDTHS = (32, 64, 96, 128, 192)


def stage_width(cout: int) -> int:
    """The kernel's N tile for ``cout`` output channels: the narrowest
    width that covers an even split of ``cout`` over ceil(cout / 192)
    blocks."""
    nblk = -(-cout // _WIDTHS[-1])
    per = -(-cout // nblk)
    return min(v for v in _WIDTHS if v >= per)


def pack_stage_weights(w: torch.Tensor, ni: int) -> torch.Tensor:
    """HWIO bf16 (k, k, cin, cout) -> the kernel's B operand images, 1-d:
    per N block of ``ni`` channels, per K chunk j of 32 input channels
    (K zero-padded to a multiple of 16), per tap t, the chunk's k16 steps
    as [step][k8 half][ni][8] — 8 channels x 8 k (128 B) per no-swizzle
    core matrix."""
    k, _, cin, cout = w.shape
    kk = k * k
    cin_pad = -(-cin // 16) * 16
    nblk = -(-cout // ni)
    wp = torch.zeros((kk, cin_pad, nblk * ni), dtype=torch.bfloat16,
                     device=w.device)
    wp[:, :cin, :cout] = w.reshape(kk, cin, cout)
    wp = wp.reshape(kk, cin_pad, nblk, ni).permute(2, 0, 1, 3)
    parts = []
    for c0 in range(0, cin_pad, 32):
        ks = min(2, (cin_pad - c0) // 16)
        part = wp[:, :, c0:c0 + 16 * ks].reshape(nblk, kk, ks, 2, 8, ni)
        parts.append(part.permute(0, 1, 2, 3, 5, 4).reshape(nblk, -1))
    return torch.cat(parts, dim=1).reshape(-1).contiguous()


@dataclass(frozen=True)
class StageWeights:
    """HWIO weights (for the plain version) beside their packed image."""
    hwio: torch.Tensor
    image: torch.Tensor
    ni: int


def prepare_stage(w: torch.Tensor) -> StageWeights:
    """Pack HWIO bf16 weights once, on their device."""
    if w.dtype != torch.bfloat16 or w.dim() != 4:
        raise TypeError(f"weights must be 4-d bfloat16, got {w.dtype} "
                        f"{tuple(w.shape)}")
    ni = stage_width(w.shape[3])
    return StageWeights(w, pack_stage_weights(w, ni), ni)


@dataclass(frozen=True)
class Epilogue:
    """The glue fused into a stage, for output channels ``[0, n_act)``:
    ``v = ((addends[0] + addends[1]) + cur) + bias``, then
    ``belu(v, slope)`` where ``slope`` is given, then (``act_dtype``
    bf16) the rounding, then the product with the {0,1} bf16 ``mask`` of
    G groups (channel o reads group o // (n_act // G)).  ``cur`` is the
    conv's value in the stage's out dtype (the f32 sum, or the sum
    rounded to bf16), widened.  ``addends`` are bf16 (B, H, W, >= n_act)
    channel slices of earlier outputs.  Channels ``[n_act, Cout)`` keep
    the conv's value and are written ``gap`` channels further on."""
    n_act: int
    bias: Optional[torch.Tensor] = None
    slope: Optional[torch.Tensor] = None
    addends: tuple = ()
    mask: Optional[torch.Tensor] = None
    act_dtype: torch.dtype = torch.bfloat16
    gap: int = 0


@dataclass(frozen=True)
class FusedStage:
    """A stage's weights (HWIO or `StageWeights`) with its epilogue: what
    `conv_stage` takes for a fused stage."""
    weights: object
    epilogue: Epilogue

    @property
    def hwio(self) -> torch.Tensor:
        w = self.weights
        return w.hwio if isinstance(w, StageWeights) else w


def _out_dtype(cout: int, out_dtype: torch.dtype,
               epi: Optional[Epilogue]) -> torch.dtype:
    """The output tensor's dtype: the activations' where every channel is
    one, else the conv's (the plain version stores bf16 activations beside
    f32 conv values as f32; the kernel refuses that mix)."""
    if epi is None or epi.act_dtype == out_dtype:
        return out_dtype
    return epi.act_dtype if epi.n_act == cout else torch.float32


def _out_buffer(x: torch.Tensor, cout: int, dtype: torch.dtype,
                epi: Optional[Epilogue]) -> torch.Tensor:
    """The output: (B, H, W, cout + gap); with an epilogue and bf16 out,
    a channel prefix of a buffer whose pixel stride is a multiple of 8,
    so that the next stage reads a prefix of it in place."""
    bsz, h, wd = x.shape[:3]
    width = cout + (epi.gap if epi is not None else 0)
    ps = -(-width // 8) * 8 if (epi is not None
                                and dtype == torch.bfloat16) else width
    buf = torch.empty((bsz, h, wd, ps), device=x.device, dtype=dtype)
    return buf[..., :width]


def stage_epilogue_reference(y: torch.Tensor, epi: Epilogue,
                             out: torch.Tensor) -> torch.Tensor:
    """The plain glue on a conv output ``y`` (in the stage's out dtype),
    written into ``out``: the tile kernels' ops, in their order."""
    n = epi.n_act
    cur = y[..., :n].float()
    v = None
    for add in epi.addends:
        v = add[..., :n].float() if v is None else v + add[..., :n].float()
    v = cur if v is None else v + cur
    if epi.bias is not None:
        v = v + epi.bias[:n]
    if epi.slope is not None:
        v = belu(v, epi.slope[:n])
    if epi.act_dtype == torch.bfloat16:
        v = v.to(torch.bfloat16)
    if epi.mask is not None:
        g = epi.mask.shape[-1]
        v = v * epi.mask.repeat_interleave(n // g, dim=-1)
    out[..., :n] = v
    out[..., n + epi.gap:] = y[..., n:]
    return out


def _split(w):
    """(HWIO weights, StageWeights or None, Epilogue or None) of ``w``."""
    epi = None
    if isinstance(w, FusedStage):
        w, epi = w.weights, w.epilogue
    if isinstance(w, StageWeights):
        return w.hwio, w, epi
    return w, None, epi


def conv_stage_reference(x: torch.Tensor, w, out_dtype: torch.dtype =
                         torch.float32) -> torch.Tensor:
    """The plain version.  float32 out: `F.conv2d` on float32 tensors that
    hold the bf16 values, TF32 off — products of two bf16 values are exact
    in f32, so only the order of the f32 sums differs from the kernel.
    bfloat16 out: a bf16 `F.conv2d` (f32 accumulation, one rounding of the
    output), the same values as the f32 form rounded once.  For a
    `FusedStage`, that conv followed by `stage_epilogue_reference`."""
    if out_dtype not in _OUT:
        raise ValueError(f"out_dtype must be float32 or bfloat16, not "
                         f"{out_dtype}")
    hwio, _, epi = _split(w)
    k = hwio.shape[0]
    xt = x.contiguous().permute(0, 3, 1, 2)
    wt = hwio.permute(3, 2, 0, 1)
    if out_dtype == torch.bfloat16:
        y = F.conv2d(xt.to(torch.bfloat16), wt.to(torch.bfloat16),
                     padding=k // 2)
    else:
        with exact_f32():
            y = F.conv2d(xt.to(torch.bfloat16).float(),
                         wt.to(torch.bfloat16).float(), padding=k // 2)
    y = y.permute(0, 2, 3, 1).contiguous()
    if epi is None:
        return y
    cout = hwio.shape[3]
    out = _out_buffer(x, cout, _out_dtype(cout, out_dtype, epi), epi)
    return stage_epilogue_reference(y, epi, out)


def _pixel_stride(t: torch.Tensor, name: str) -> int:
    """The pixel stride of a (B, H, W, C) channel slice of a dense
    (B, H, W, P) buffer; raises for any other layout."""
    if t.dim() != 4:
        raise ValueError(f"{name} must be 4-d, got {tuple(t.shape)}")
    bsz, h, wd, c = t.shape
    ps = t.stride(2)
    if (t.stride(3) != 1 and c > 1) or ps < c or \
            (h > 1 and t.stride(1) != wd * ps) or \
            (bsz > 1 and t.stride(0) != h * wd * ps):
        raise ValueError(f"{name} must be a channel slice of a dense NHWC "
                         f"buffer, got strides {t.stride()}")
    return ps


def _check_bf16(t: torch.Tensor, name: str, device) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name} has dtype {t.dtype}, expected bfloat16")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")


def _epilogue_args(epi: Optional[Epilogue], x: torch.Tensor, cout: int,
                   out_dtype: torch.dtype) -> list:
    """The kernel's epilogue arguments (n_act, gap, cur_bf16, act, bias,
    slope, add0, its pixel stride, add1, its pixel stride, mask, groups),
    checked."""
    if epi is None:
        return [0, 0, 0, 0, None, None, None, 0, None, 0, None, 0]
    n = epi.n_act
    if not 0 < n <= cout or epi.gap < 0 or len(epi.addends) > 2:
        raise ValueError(f"epilogue n_act {n} / gap {epi.gap} / "
                         f"{len(epi.addends)} addends do not fit Cout {cout}")
    if epi.act_dtype not in _OUT or (n < cout and epi.act_dtype != out_dtype):
        raise ValueError(f"activations in {epi.act_dtype} beside conv "
                         f"channels in {out_dtype}")
    vecs = []
    for name, v in (("bias", epi.bias), ("slope", epi.slope)):
        if v is None:
            vecs.append(None)
            continue
        if v.dtype != torch.float32 or v.device != x.device or \
                not v.is_contiguous() or v.dim() != 1 or v.numel() < n:
            raise ValueError(f"{name} must be a contiguous float32 vector "
                             f"of >= {n} on {x.device}")
        vecs.append(v.data_ptr())
    adds = []
    for i, a in enumerate(epi.addends):
        _check_bf16(a, f"addend {i}", x.device)
        ps = _pixel_stride(a, f"addend {i}")
        if a.shape[:3] != x.shape[:3] or a.shape[3] < n:
            raise ValueError(f"addend {i} {tuple(a.shape)} does not cover "
                             f"{tuple(x.shape[:3])} x {n}")
        adds += [a.data_ptr(), ps]
    adds += [None, 0] * (2 - len(epi.addends))
    mask, groups = None, 0
    if epi.mask is not None:
        m = epi.mask
        _check_bf16(m, "mask", x.device)
        if m.dim() != 4 or m.shape[:3] != x.shape[:3] or \
                not m.is_contiguous() or n % m.shape[3]:
            raise ValueError(f"mask must be contiguous (B, H, W, G) with G "
                             f"dividing {n}, got {tuple(m.shape)}")
        mask, groups = m.data_ptr(), m.shape[3]
    return [n, epi.gap, int(out_dtype == torch.bfloat16),
            int(epi.slope is not None), *vecs, *adds, mask, groups]


def conv_stage(x: torch.Tensor, w, out_dtype: torch.dtype = torch.float32
               ) -> torch.Tensor:
    """Same-padded conv of bf16 ``x`` (B, H, W, Cin) with bf16 weights (k,
    k, Cin, Cout), k odd, accumulated in f32, in ``out_dtype`` (float32,
    or bfloat16 rounded to nearest-even).  ``w`` is HWIO, a
    `prepare_stage` result, or a `FusedStage`: then the result is (B, H,
    W, Cout + gap), its first n_act channels the epilogue's activations
    (in its ``act_dtype``).

    CPU tensors take `conv_stage_reference`; CUDA tensors launch the
    kernel on the current stream (no synchronisation).  ``x`` may be a
    channel slice of a dense buffer (a stage's output read in place) when
    its pixel stride and Cin are multiples of 8; other inputs are first
    copied (and Cin zero-padded) into that form."""
    global LAUNCHES
    if out_dtype not in _OUT:
        raise ValueError(f"out_dtype must be float32 or bfloat16, not "
                         f"{out_dtype}")
    if x.device.type == "cpu":
        return conv_stage_reference(x, w, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"conv_stage runs on cpu or cuda, not {x.device}")
    hwio, sw, epi = _split(w)
    _check_bf16(x, "x", x.device)
    _check_bf16(hwio, "w", x.device)
    if x.dim() != 4 or hwio.dim() != 4:
        raise ValueError(f"x and w must be 4-d, got {tuple(x.shape)} and "
                         f"{tuple(hwio.shape)}")
    if not hwio.is_contiguous():
        raise ValueError("w is not contiguous")
    bsz, h, wd, cin = x.shape
    k, k2, wcin, cout = hwio.shape
    if k != k2 or k not in (1, 3, 5) or wcin != cin:
        raise ValueError(f"weights {tuple(hwio.shape)} are not (k, k, {cin}, "
                         "Cout) with k in (1, 3, 5)")
    if cin > 256:
        raise ValueError(f"at most 256 input channels, got {cin}")
    ps = _pixel_stride(x, "x")
    if cin % 8 or ps % 8 or x.data_ptr() % 16:
        cin8 = -(-cin // 8) * 8
        x = F.pad(x, (0, cin8 - cin)).contiguous()
        hwio = F.pad(hwio, (0, 0, 0, cin8 - cin)).contiguous()
        sw, cin, ps = None, cin8, cin8
    if sw is None:
        sw = prepare_stage(hwio)
    if sw.image.device != x.device:
        raise ValueError(f"w is on {sw.image.device}, x on {x.device}")
    args = _epilogue_args(epi, x, cout, out_dtype)
    out = _out_buffer(x, cout, _out_dtype(cout, out_dtype, epi), epi)
    if out.numel() == 0:
        return out
    from rusty_sr_tpu_torch.ops.cuda import _build
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.srt_conv_stage(
            x.data_ptr(), ps, sw.image.data_ptr(), out.data_ptr(),
            out.stride(2), bsz, h, wd, cin, cout, k, sw.ni,
            int(out.dtype == torch.bfloat16), *args,
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError("conv-stage kernel launch failed: "
                           f"{lib.srt_error_string(rc).decode()} ({rc})")
    LAUNCHES += 1
    key = (k, wcin, cout)
    SHAPE_LAUNCHES[key] = SHAPE_LAUNCHES.get(key, 0) + 1
    return out
