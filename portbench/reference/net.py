"""The reference's super-resolution network and its training step, plain.

The topology (SURVEY.md section 2.3; the reference's `sr_net`):

    base   = bilinear x f of the input (half-pixel phase, edge clamp)
    f      = BeLU(conv0_5x5(x) + f_bias)
    l1     = BeLU(conv1_5x5(f) + l1_bias)
    l2     = BeLU(conv2_5x5(f) + conv5_3x3(l1) + l2_bias)
    l3     = BeLU(conv3_5x5(f) + conv6_3x3(l1) + conv8_3x3(l2) + l3_bias)
    expand = conv7_3x3(l1) + conv9_3x3(l2) + conv10_3x3(l3) + expand_bias
    out    = base + depth_to_space(expand)      # channel order (fy, fx, c)

with BeLU(x) = p * x + sqrt(x^2 + 1) - 1 and zero "same" padding.  The
computation is NCHW float32 through `torch.nn.functional`, with TF32
off.  ``quant`` rounds every convolution's operands first (the
lower-precision controls); the sums stay float32.
"""

from __future__ import annotations

import contextlib
import struct

import numpy as np
import torch
import torch.nn.functional as F

# MSRA gains of the reference's initialisation (conv0 1.0, the rest 0.1).
_GAINS = {"conv0": 1.0}


def param_specs(cfg: dict) -> list:
    """(name, shape) in the `.rsr` file's order; convolutions OHWI."""
    n, c = cfg["width"], cfg["channels"]
    e = c * cfg["factor"] ** 2
    k0, k1, k3 = cfg["conv0_kernel"], cfg["conv1_3_kernel"], \
        cfg["conv5_10_kernel"]
    return [("conv0", (n, k0, k0, c)), ("f_bias", (n,)), ("f_belu", (n,)),
            ("expand_bias", (e,)),
            ("l1_bias", (n,)), ("l2_bias", (n,)), ("l3_bias", (n,)),
            ("l1_belu", (n,)), ("l2_belu", (n,)), ("l3_belu", (n,)),
            ("conv1", (n, k1, k1, n)), ("conv2", (n, k1, k1, n)),
            ("conv3", (n, k1, k1, n)),
            ("conv5", (n, k3, k3, n)), ("conv6", (n, k3, k3, n)),
            ("conv7", (e, k3, k3, n)), ("conv8", (n, k3, k3, n)),
            ("conv9", (e, k3, k3, n)), ("conv10", (e, k3, k3, n))]


def read_rsr(path: str, cfg: dict) -> dict:
    """A `.rsr` file (u32 count, u32 size table, f32 payload) -> name ->
    float32 array, convolutions OIHW."""
    with open(path, "rb") as f:
        data = f.read()
    (count,) = struct.unpack_from("<I", data, 0)
    if len(data) != 4 + 8 * count:
        raise ValueError(f"{path}: {len(data)} bytes for {count} values")
    flat = np.frombuffer(data, "<f4", count, 4 + 4 * count)
    out, off = {}, 0
    for name, shape in param_specs(cfg):
        size = int(np.prod(shape))
        v = flat[off:off + size].reshape(shape).astype(np.float32)
        out[name] = v.transpose(0, 3, 1, 2).copy() if v.ndim == 4 else v
        off += size
    if off != count:
        raise ValueError(f"{path}: {count} values, the network has {off}")
    return out


def init_params(seed: int, cfg: dict) -> dict:
    """The reference's initialisation drawn from ``seed``: convolutions
    MSRA normal, std = gain * sqrt(2 / fan_in), drawn in the file's order
    and layout; biases 0; BeLU slopes 1, 0, 1, 0, ...  Convolutions OIHW."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in param_specs(cfg):
        if len(shape) == 4:
            co, kh, kw, ci = shape
            std = _GAINS.get(name, 0.1) * np.sqrt(2.0 / (kh * kw * ci))
            w = rng.normal(0.0, std, size=shape).astype(np.float32)
            out[name] = w.transpose(0, 3, 1, 2).copy()
        elif name.endswith("_belu"):
            p = np.zeros(shape, np.float32)
            p[0::2] = 1.0
            out[name] = p
        else:
            out[name] = np.zeros(shape, np.float32)
    return out


def hwio(tree: dict) -> dict:
    """OIHW convolutions -> HWIO (the layout of the program's trees)."""
    return {k: (v.transpose(2, 3, 1, 0).copy() if v.ndim == 4 else v.copy())
            for k, v in tree.items()}


def oihw(tree: dict) -> dict:
    """HWIO convolutions -> OIHW (the inverse of `hwio`)."""
    return {k: (np.asarray(v).transpose(3, 2, 0, 1) if np.ndim(v) == 4
                else np.asarray(v)) for k, v in tree.items()}


@contextlib.contextmanager
def exact_f32():
    """TF32 off for cuDNN and cuBLAS inside the block."""
    keep = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = keep


def belu(x, p):
    return p.view(1, -1, 1, 1) * x + torch.sqrt(x * x + 1.0) - 1.0


def depth_to_space(x: torch.Tensor, f: int) -> torch.Tensor:
    """(N, f*f*C, H, W) with channel (fy*f + fx)*C + c -> (N, C, fH, fW)."""
    n, cff, h, w = x.shape
    c = cff // (f * f)
    return x.view(n, f, f, c, h, w).permute(0, 3, 4, 1, 5, 2) \
        .reshape(n, c, h * f, w * f)


def forward(p: dict, x: torch.Tensor, f: int, quant=None) -> torch.Tensor:
    """(N, 3, H, W) sRGB in [0, 1] -> (N, 3, fH, fW); ``p`` name ->
    tensor, convolutions OIHW."""
    q = quant or (lambda t: t)

    def cv(h, name):
        w = p[name]
        return F.conv2d(q(h), q(w), padding=w.shape[-1] // 2)

    base = F.interpolate(x, scale_factor=f, mode="bilinear",
                         align_corners=False)
    f0 = belu(cv(x, "conv0") + p["f_bias"].view(1, -1, 1, 1), p["f_belu"])
    l1 = belu(cv(f0, "conv1") + p["l1_bias"].view(1, -1, 1, 1), p["l1_belu"])
    l2 = belu(cv(f0, "conv2") + cv(l1, "conv5")
              + p["l2_bias"].view(1, -1, 1, 1), p["l2_belu"])
    l3 = belu(cv(f0, "conv3") + cv(l1, "conv6") + cv(l2, "conv8")
              + p["l3_bias"].view(1, -1, 1, 1), p["l3_belu"])
    expand = (cv(l1, "conv7") + cv(l2, "conv9") + cv(l3, "conv10")
              + p["expand_bias"].view(1, -1, 1, 1))
    return base + depth_to_space(expand, f)


def to_u8(x: torch.Tensor) -> torch.Tensor:
    """floor(clip(x, 0, 1) * 255 + 0.5): the reference's quantisation."""
    return torch.floor(torch.clamp(x, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def upscale_u8(p: dict, img: np.ndarray, f: int, device,
               quant=None) -> np.ndarray:
    """(H, W, 3) u8 -> (fH, fW, 3) u8 through `forward`, with TF32 off."""
    x = torch.as_tensor(img, device=device).permute(2, 0, 1)[None]
    with exact_f32(), torch.no_grad():
        y = forward(p, x.float() / 255.0, f, quant)
    return to_u8(y[0].permute(1, 2, 0)).cpu().numpy()


def srgb_to_linear(s):
    return torch.where(s <= 0.04045, s / 12.92,
                       torch.clamp_min((s + 0.055) / 1.055, 1e-12) ** 2.4)


def linear_to_srgb(v):
    return torch.where(v <= 0.0031308, 12.92 * v,
                       1.055 * torch.clamp_min(v, 1e-12) ** (1 / 2.4)
                       - 0.055)


def make_lr(hr: torch.Tensor, f: int) -> torch.Tensor:
    """The training pair's input: sRGB -> linear -> f x f mean -> sRGB."""
    return linear_to_srgb(F.avg_pool2d(srgb_to_linear(hr), f))


def train_steps(tree0: dict, batches, cfg: dict, recipe: dict, device,
                quant=None, keep=None) -> dict:
    """Adam steps of the reference's recipe from ``tree0`` (OIHW numpy) on
    ``batches`` ((N, H, W, 3) u8 HR crops): the loss is the sRGB MSE plus
    1/2 * l2 * sum(w^2) over every parameter; Adam with bias correction,
    ``p -= lr * m_hat / (sqrt(v_hat) + eps)``.  ``keep(batch)`` may
    change a batch first (a planted fault).  Returns the losses, the
    first step's gradient and each leaf's change after the last step
    (name -> float64 numpy)."""
    f = cfg["factor"]
    b1, b2 = recipe["beta1"], recipe["beta2"]
    p = {k: torch.tensor(v, device=device, requires_grad=True)
         for k, v in tree0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, grad1 = [], None
    with exact_f32():
        for t, hr_u8 in enumerate(batches, 1):
            if keep is not None:
                hr_u8 = keep(hr_u8)
            hr = torch.as_tensor(hr_u8, device=device).permute(0, 3, 1, 2) \
                .float() / 255.0
            out = forward(p, make_lr(hr, f), f, quant)
            loss = torch.mean((out - hr) ** 2) + 0.5 * recipe["l2_reg"] * \
                sum(torch.sum(w * w) for w in p.values())
            grads = torch.autograd.grad(loss, list(p.values()))
            losses.append(loss.item())
            with torch.no_grad():
                if grad1 is None:
                    grad1 = {k: g.double().cpu().numpy()
                             for k, g in zip(p, grads)}
                for (k, w), g in zip(p.items(), grads):
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    m_hat = m[k] / (1 - b1 ** t)
                    v_hat = v2[k] / (1 - b2 ** t)
                    w.sub_(recipe["learning_rate"] * m_hat
                           / (torch.sqrt(v_hat) + recipe["epsilon"]))
    delta = {k: w.detach().double().cpu().numpy() - tree0[k].astype(np.float64)
             for k, w in p.items()}
    return {"losses": losses, "grad1": grad1, "delta": delta}


def _scaled_cast(t: torch.Tensor, dtype, fmax: float) -> torch.Tensor:
    """``t`` through ``dtype`` with one scale per tensor (amax at fmax)."""
    amax = t.abs().max()
    s = torch.where(amax > 0, amax / fmax, torch.ones_like(amax))
    return (t / s).to(dtype).to(t.dtype) * s


class _Fp8(torch.autograd.Function):
    """float8 training's rounding: operands in e4m3 on the way forward,
    gradients in e5m2 on the way back, one scale per tensor."""

    @staticmethod
    def forward(ctx, t):
        return _scaled_cast(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _scaled_cast(g, torch.float8_e5m2, 57344.0)


def fp8_quant(t: torch.Tensor) -> torch.Tensor:
    """The control of the bf16 configurations: every convolution operand
    in float8 e4m3, and in training the gradients that flow back through
    it in e5m2."""
    return _Fp8.apply(t)


def tf32_quant(t: torch.Tensor) -> torch.Tensor:
    """Operands rounded to TF32's 10 mantissa bits (to nearest, ties
    away), summed in float32: the control of the exact float32 tier."""
    bits = t.detach().contiguous().view(torch.int32)
    q = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return t + (q - t.detach())


QUANTS = {"f32": None, "fp8": fp8_quant, "tf32": tf32_quant}
