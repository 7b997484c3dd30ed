"""The fused SR trunk: conv0 -> convA -> convB -> convC -> conv10 per
halo'd tile, with bias, BeLU and the border mask between the stages.

Counterpart of `rusty_sr_tpu/ops/pallas/trunk.py`, in both of its modes:
exact f32, and bf16 operands and activations with f32 accumulation (the
fast tier).  `fused_trunk` runs the hand-written CUDA kernel
`csrc/trunk.cu` on CUDA tensors and its plain PyTorch version
`fused_trunk_reference` on CPU tensors; on any other device, or on a
build or launch failure, it raises.  `LAUNCHES` counts the kernel's
launches per mode.  The f32 mode runs on an FMA core that stages the
padded weight rows (`"<name>_padded"`) through shared memory; the bf16
mode on the tensor cores (wgmma), which read the weights packed once into
the B operand's image (`"w_mma"`, `mma_image`).

Layouts: tiles are NHWC, (B, S + 2*HALO, S + 2*HALO, C), zero-padded,
with a (B, S + 2*HALO, S + 2*HALO, 1) {0,1} mask that is 1 inside the
true image; the result is `expand`, (B, S, S, C*f^2), the pre-shuffle
residual with the halo cropped.  Each stage shrinks the extent by its
radius (f at +5, l1 at +3, l2 at +2, l3 at +1 around the output), so no
stage pads, and the mask, applied after every BeLU, gives every conv the
zeros a whole-image Same-padded conv sees at the true border.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from rusty_sr_tpu_torch.ops.activations import belu
from rusty_sr_tpu_torch.ops.conv import exact_f32

HALO = 7   # trunk receptive-field radius in LR px

# Launches of the CUDA kernel, per mode, since the counts were last set
# to 0.
LAUNCHES = {torch.float32: 0, torch.bfloat16: 0}

# The kernel reads weight rows in 16-byte pieces, from rows padded to a
# multiple of WPAD columns (csrc/trunk.cu); the trunk width must be one
# too.
_WPAD = 8

_MATS = ("w0", "wA", "wB", "wC", "wD")
_VECS = ("f_bias", "f_belu", "l1_bias", "l1_belu", "l2_bias", "l2_belu",
         "l3_bias", "l3_belu", "expand_bias")

# Kernel entry points by mode.
_ENTRY = {torch.float32: "srt_trunk_f32", torch.bfloat16: "srt_trunk_bf16"}

# The bf16 kernel's N chunks.  This and _stage_geometry must match
# csrc/trunk.cu's TB_MAXN and tb_plan (the host test of the kernel runs it
# on the image that mma_image packs).
_MAXN = 96


def _padded(w: torch.Tensor) -> torch.Tensor:
    """A (K, N) matrix with its columns zero-padded to a multiple of _WPAD,
    starting on a 16-byte boundary (the kernel's 16-byte weight loads)."""
    pad = -w.shape[1] % _WPAD
    if pad:
        return F.pad(w, (0, pad))
    return w if w.data_ptr() % 16 == 0 else w.clone()


def _stage_geometry(cimg: int, n: int, e: int):
    """(matrix, taps, channels a tap, columns) of each stage as the bf16
    kernel runs it: conv0's 5 dx taps of a row read as 5*cimg channels."""
    return (("w0", 5, 5 * cimg, n), ("wA", 25, n, 3 * n),
            ("wB", 9, n, 2 * n + e), ("wC", 9, n, n + e), ("wD", 9, n, e))


def _chunks(ncol: int):
    """(first column, width) of each N chunk of a stage: widths of at
    most 96, the last one rounded up to a multiple of 32."""
    w = -(-ncol // 32) * 32
    return [(c0, min(_MAXN, w - c0)) for c0 in range(0, w, _MAXN)]


def mma_image_len(cimg: int, n: int, e: int) -> int:
    """Elements of `mma_image` for these widths."""
    return sum(taps * -(-cin // 16) * 16 * -(-ncol // 32) * 32
               for _, taps, cin, ncol in _stage_geometry(cimg, n, e))


def mma_image(mats: dict, cimg: int, n: int, e: int) -> torch.Tensor:
    """The bf16 matrices as the wgmma B operand's shared-memory image, in
    the order the kernel streams it: per stage, per N chunk, per k16 step
    (tap-major, 16 channels a step) the no-swizzle K-major core matrices
    [k8 half][column][8].  K pads to a multiple of 16 and N to the chunk
    width with zeros."""
    parts = []
    for name, taps, cin, ncol in _stage_geometry(cimg, n, e):
        kpad = -(-cin // 16) * 16
        w = mats[name].reshape(taps, cin, ncol)
        w = F.pad(w, (0, -(-ncol // 32) * 32 - ncol, 0, kpad - cin))
        for c0, width in _chunks(ncol):
            b = w[:, :, c0:c0 + width].reshape(taps, kpad // 16, 2, 8, width)
            parts.append(b.permute(0, 1, 2, 4, 3).reshape(-1))
    return torch.cat(parts).contiguous()


def pack_trunk_weights(params, factor: int = 3,
                       dtype: torch.dtype = torch.float32) -> dict:
    """HWIO conv weights -> (kh*kw*Cin, Cout) matrices of ``dtype``
    (float32 or bfloat16), with same-source convs merged along Cout
    (conv1|2|3 -> wA, conv5|6|7 -> wB, conv8|9 -> wC), and the bias/BeLU
    vectors as (1, N) float32 — the JAX packer's dict, bit for bit.

    The kernel's weight forms are made once here, so no launch copies
    weights: in f32 each matrix also comes as ``"<name>_padded"``, its
    columns zero-padded; in bf16 the matrices come as the tensor-core
    kernel's B operand image, ``"w_mma"`` (`mma_image`).  Takes a
    raw or a merged (`models.sr_net.merge_params`) tree of arrays or
    tensors; the result stays on the tree's device."""
    from rusty_sr_tpu_torch.models.sr_net import merge_params

    if dtype not in _ENTRY:
        raise ValueError(f"dtype must be float32 or bfloat16, not {dtype}")

    def t(v):
        return torch.as_tensor(v, dtype=torch.float32)

    p = {k: t(v) for k, v in params.items()}
    if "convA" not in p:
        p = merge_params(p)
    cin = p["conv0"].shape[2]
    e = cin * factor * factor
    got = p["conv10"].shape[-1]
    if got != e:
        raise ValueError(
            f"params expand to {got} channels but factor {factor} with "
            f"{cin} input channels needs {e} (C*factor^2) — wrong weights "
            "for this factor")

    def flat(w):
        return w.reshape(-1, w.shape[-1]).to(dtype).contiguous()

    out = {"w0": flat(p["conv0"]), "wA": flat(p["convA"]),
           "wB": flat(p["convB"]), "wC": flat(p["convC"]),
           "wD": flat(p["conv10"])}
    for k in _VECS:
        out[k] = p[k].reshape(1, -1).contiguous()
    if dtype == torch.float32:
        for k in _MATS:
            out[k + "_padded"] = _padded(out[k])
    else:
        out["w_mma"] = mma_image(out, cin, out["w0"].shape[1], e)
    return out


def _conv_valid(t: torch.Tensor, w_kn: torch.Tensor, k: int) -> torch.Tensor:
    """NCHW valid cross-correlation with a (k*k*Cin, Cout) matrix whose
    rows run (dy, dx, ci)."""
    w = w_kn.reshape(k, k, t.shape[1], -1).permute(3, 2, 0, 1)
    return F.conv2d(t, w)


def _mode(packed, compute_dtype) -> torch.dtype:
    cd = compute_dtype or packed["w0"].dtype
    if cd not in _ENTRY:
        raise ValueError(f"compute_dtype must be float32 or bfloat16, "
                         f"not {cd}")
    return cd


def fused_trunk_reference(packed, x: torch.Tensor, mask: torch.Tensor,
                          factor: int = 3,
                          compute_dtype: torch.dtype | None = None,
                          exact_sums: bool = False) -> torch.Tensor:
    """Plain PyTorch `expand` for zero-padded tiles: the kernel's math on
    whole tiles.  ``compute_dtype`` defaults to the packed matrices'.

    float32: full float32 throughout (TF32 off).  bfloat16: the values
    are rounded to bf16 exactly where the Pallas kernel rounds them — x,
    the weights, each activation after its BeLU, each stage output a, b,
    c after its own BeLU has read it in f32 — and every convolution sums
    exact products of those values in f32.  The convolutions run on f32
    tensors that hold bf16 values: a bf16 `conv2d` would round each stage
    output before its BeLU, where the Pallas kernel does not.

    With ``exact_sums`` each convolution sums in float64 and rounds once to
    f32, the rest unchanged: a witness for the error of the f32 sums, this
    function's and the kernel's."""
    cd = _mode(packed, compute_dtype)
    n = packed["f_bias"].shape[-1]
    e = x.shape[-1] * factor * factor

    def rnd(t):
        return t if cd == torch.float32 else t.to(cd).float()

    def v(name):
        return packed[name].reshape(1, -1, 1, 1)

    def conv(t, name, k):
        wt = rnd(packed[name].float())
        if exact_sums:
            return _conv_valid(t.double(), wt.double(), k).float()
        return _conv_valid(t, wt, k)

    xt = rnd(x.permute(0, 3, 1, 2))
    mt = mask.permute(0, 3, 1, 2)

    def act(pre, name, off):
        hh, ww = mt.shape[2], mt.shape[3]
        m = mt[:, :, off:hh - off, off:ww - off]
        return rnd(belu(pre + v(name + "_bias"), v(name + "_belu"))) * m

    def inner(t, k):
        return t[:, :, k:t.shape[2] - k, k:t.shape[3] - k]

    with exact_f32():
        f = act(conv(xt, "w0", 5), "f", 2)
        a = conv(f, "wA", 5)
        l1 = act(a[:, :n], "l1", 4)
        a = rnd(a)
        b = conv(l1, "wB", 3)
        l2 = act(inner(a[:, n:2 * n], 1) + b[:, :n], "l2", 5)
        b = rnd(b)
        c = conv(l2, "wC", 3)
        l3 = act(inner(a[:, 2 * n:3 * n], 2) + inner(b[:, n:2 * n], 1)
                 + c[:, :n], "l3", 6)
        c = rnd(c)
        d = conv(l3, "wD", 3)
        expand = (inner(b[:, 2 * n:2 * n + e], 2) + inner(c[:, n:n + e], 1)
                  + d + v("expand_bias"))
    return expand.permute(0, 2, 3, 1).contiguous()


def _check(name: str, t: torch.Tensor, shape, device,
           dtype=torch.float32) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _aligned(name: str, t: torch.Tensor) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{name} does not start on a 16-byte boundary")


def fused_trunk(packed, x: torch.Tensor, mask: torch.Tensor,
                factor: int = 3,
                compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """`expand` (B, S, S, C*f^2) float32 for zero-padded float32 tiles x
    (B, S+14, S+14, C) and their mask (B, S+14, S+14, 1).

    The mode is the packed matrices' dtype (`pack_trunk_weights`);
    ``compute_dtype``, if given, must name the same.  CPU tensors take
    `fused_trunk_reference`; CUDA tensors launch the kernel on the
    current stream (no synchronisation)."""
    cd = _mode(packed, compute_dtype)
    if x.device.type == "cpu":
        return fused_trunk_reference(packed, x, mask, factor, cd)
    if x.device.type != "cuda":
        raise ValueError(f"fused_trunk runs on cpu or cuda, not {x.device}")
    if cd != packed["w0"].dtype:
        raise ValueError(f"compute_dtype {cd} needs weights packed as {cd}, "
                         f"not {packed['w0'].dtype}")
    if x.dim() != 4 or x.shape[1] != x.shape[2]:
        raise ValueError(f"x must be (B, side, side, C), got {tuple(x.shape)}")
    bsz, side, _, cin = x.shape
    s = side - 2 * HALO
    n = packed["f_bias"].shape[-1]
    e = cin * factor * factor
    if s < 1 or bsz > 65535:
        raise ValueError(f"tiles of side {side} in a batch of {bsz}: need "
                         f"side > {2 * HALO} and at most 65535 tiles")
    if n % _WPAD:
        raise ValueError(f"the kernel takes trunk widths that are multiples "
                         f"of {_WPAD}, not {n}")
    dev = x.device
    _check("x", x, (bsz, side, side, cin), dev)
    _check("mask", mask, (bsz, side, side, 1), dev)
    for name, k, cols in (("w0", 25 * cin, n), ("wA", 25 * n, 3 * n),
                          ("wB", 9 * n, 2 * n + e), ("wC", 9 * n, n + e),
                          ("wD", 9 * n, e)):
        _check(name, packed[name], (k, cols), dev, cd)
        if cd == torch.float32:
            _check(name + "_padded", packed[name + "_padded"],
                   (k, -(-cols // _WPAD) * _WPAD), dev, cd)
            _aligned(name + "_padded", packed[name + "_padded"])
    if cd == torch.bfloat16:
        if "w_mma" not in packed:
            raise ValueError("the bf16 kernel needs the weights' B operand "
                             "image, w_mma (pack_trunk_weights)")
        _check("w_mma", packed["w_mma"], (mma_image_len(cin, n, e),), dev,
               cd)
        _aligned("w_mma", packed["w_mma"])
    for name in _VECS:
        _check(name, packed[name], (1, e if name == "expand_bias" else n),
               dev)
    out = torch.empty((bsz, s, s, e), device=dev, dtype=torch.float32)
    if bsz == 0:
        return out
    from rusty_sr_tpu_torch.ops.cuda import _build
    lib = _build.load()
    mats = ([packed[k + "_padded"] for k in _MATS] if cd == torch.float32
            else [packed["w_mma"]])
    ptrs = [t.data_ptr() for t in
            (x, mask, *mats, *(packed[k] for k in _VECS), out)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, _ENTRY[cd])(*ptrs, bsz, s, cin, n, e,
                                      ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError("trunk kernel launch failed: "
                           f"{lib.srt_error_string(rc).decode()} ({rc})")
    LAUNCHES[cd] += 1
    return out
