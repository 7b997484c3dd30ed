"""SwinIR's shifted-window attention on token-major activations.

Replaces no TPU kernel (the JAX package runs no attention).  `window_attn`
runs the hand-written CUDA kernel `csrc/window_attn.cu` on CUDA tensors
and `window_attn_reference`, its plain version, on CPU tensors; the exact
tier of `models.swinir` calls the plain version on any device.

Both take ``qkv`` (frames, P*Q, 3*C), the `qkv` projection's output in
SwinIR's channel order (part*C + head*hd + d, part q/k/v; wider rows,
whose first 3*C channels are read, with ``channels`` = C), and ``bias``
(heads, 64, 64), the relative-position bias gathered for one block
(`relative_bias`), and return (frames, P*Q, C) in the grid's own token
order (rows of ``out_width`` with zero columns after C, where given):
the grid rolled by (-shift, -shift), cut into 8x8 windows,
``softmax(q k^T * hd^-0.5 + bias + mask) v`` per window and head, the
windows merged and rolled back.  The mask is SwinIR's `calculate_mask`
for a P x Q grid (`shift_mask`).  `LAUNCHES` counts the kernel's
launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

WINDOW = 8
LAUNCHES = 0


def relative_index(window: int = WINDOW) -> torch.Tensor:
    """(w*w, w*w) int64: SwinIR's ``relative_position_index``, the row of
    the (2w-1)^2 table for each pair of positions (i, j) of a window:
    (yi - yj + w - 1) * (2w - 1) + (xi - xj + w - 1)."""
    ys, xs = torch.meshgrid(torch.arange(window), torch.arange(window),
                            indexing="ij")
    ys, xs = ys.reshape(-1), xs.reshape(-1)
    dy = ys[:, None] - ys[None, :] + window - 1
    dx = xs[:, None] - xs[None, :] + window - 1
    return dy * (2 * window - 1) + dx


def relative_bias(table: torch.Tensor, window: int = WINDOW) -> torch.Tensor:
    """A block's ((2w-1)^2, heads) table -> (heads, w*w, w*w) float32."""
    idx = relative_index(window).to(table.device)
    return table.float()[idx.reshape(-1)].reshape(
        window * window, window * window, -1).permute(2, 0, 1).contiguous()


def shift_mask(height: int, width: int, shift: int,
               window: int = WINDOW, device="cpu") -> torch.Tensor:
    """(windows, w*w, w*w) float32 of SwinIR's `calculate_mask` for a
    height x width grid: 0 where two tokens of a window carry the same
    label, -100 where not.  Rows (and columns) of the rolled grid are
    labelled by [0, n-w), [n-w, n-shift), [n-shift, n)."""
    def labels(n):
        r = torch.arange(n, device=device)
        return (r >= n - window).long() + (r >= n - shift).long()
    lab = labels(height)[:, None] * 3 + labels(width)[None, :]
    win = lab.reshape(height // window, window, width // window, window) \
        .permute(0, 2, 1, 3).reshape(-1, window * window)
    diff = win[:, :, None] != win[:, None, :]
    return torch.where(diff, -100.0, 0.0).float()


def window_attn_reference(qkv: torch.Tensor, bias: torch.Tensor, shift: int,
                          height: int, width: int, channels=None,
                          out_width=None) -> torch.Tensor:
    """The plain version: roll, window partition, attention in float32
    (q scaled first, then bias, then mask, as SwinIR orders them), merge,
    roll back; the result in ``qkv``'s dtype."""
    f, n = qkv.shape[:2]
    c = channels or qkv.shape[2] // 3
    c3, heads, w = 3 * c, bias.shape[0], WINDOW
    hd = c // heads
    x = qkv[..., :c3].float().reshape(f, height, width, c3)
    if shift:
        x = torch.roll(x, (-shift, -shift), (1, 2))
    x = x.reshape(f, height // w, w, width // w, w, 3, heads, hd) \
        .permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, -1, heads, w * w, hd)
    q, k, v = x[0] * hd ** -0.5, x[1], x[2]
    attn = q @ k.transpose(-2, -1) + bias.float()
    if shift:
        m = shift_mask(height, width, shift, w, qkv.device)
        attn = (attn.reshape(f, -1, heads, w * w, w * w)
                + m[None, :, None]).reshape(attn.shape)
    o = torch.softmax(attn, dim=-1) @ v
    o = o.reshape(f, height // w, width // w, heads, w, w, hd) \
        .permute(0, 1, 4, 2, 5, 3, 6).reshape(f, height, width, c)
    if shift:
        o = torch.roll(o, (shift, shift), (1, 2))
    o = o.reshape(f, n, c).to(qkv.dtype)
    return o if out_width in (None, c) else F.pad(o, (0, out_width - c))


def window_attn(qkv: torch.Tensor, bias: torch.Tensor, shift: int,
                height: int, width: int, channels=None,
                out_width=None) -> torch.Tensor:
    """bf16 ``qkv`` -> bf16 output (see the module); CPU tensors take
    `window_attn_reference`, CUDA tensors launch ``window_attn_kernel``
    on the current stream (no synchronisation)."""
    global LAUNCHES
    c = channels or (qkv.shape[2] // 3 if qkv.dim() == 3 else 0)
    if qkv.dim() != 3 or c < 1 or qkv.shape[2] < 3 * c \
            or (channels is None and qkv.shape[2] % 3):
        raise ValueError(f"qkv must be (frames, tokens, 3*C), got "
                         f"{tuple(qkv.shape)}")
    if out_width is not None and out_width < c:
        raise ValueError(f"out_width {out_width} is under {c} channels")
    f, n, ldi = qkv.shape
    heads, ldo = bias.shape[0], out_width or c
    if n != height * width or height % WINDOW or width % WINDOW:
        raise ValueError(f"{n} tokens are not a {height}x{width} grid of "
                         f"whole {WINDOW}x{WINDOW} windows")
    if c % heads or bias.shape[1:] != (WINDOW * WINDOW,) * 2:
        raise ValueError(f"bias {tuple(bias.shape)} does not fit {c} "
                         "channels")
    if not 0 <= shift < WINDOW:
        raise ValueError(f"shift must be in [0, {WINDOW}), got {shift}")
    if qkv.device.type == "cpu":
        return window_attn_reference(qkv, bias, shift, height, width,
                                     channels, out_width)
    if qkv.device.type != "cuda":
        raise ValueError(f"window_attn runs on cpu or cuda, not "
                         f"{qkv.device}")
    hd = c // heads
    if qkv.dtype != torch.bfloat16 or bias.dtype != torch.float32:
        raise TypeError(f"the kernel takes bf16 qkv and f32 bias, not "
                        f"{qkv.dtype} and {bias.dtype}")
    if hd % 2 or hd > 32 or ldi % 2 or ldo % 2:
        raise ValueError(f"the kernel takes an even head width up to 32 and "
                         f"even rows, not {hd}, {ldi} and {ldo}")
    if not (qkv.is_contiguous() and bias.is_contiguous()):
        raise ValueError("qkv and bias must be contiguous")
    if bias.device != qkv.device:
        raise ValueError(f"bias is on {bias.device}, qkv on {qkv.device}")
    out = torch.empty((f, n, ldo), device=qkv.device, dtype=torch.bfloat16)
    if out.numel() == 0:
        return out
    from rusty_sr_tpu_torch.ops.cuda import _build
    lib = _build.load()
    with torch.cuda.device(qkv.device):
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(qkv.device).cuda_stream)
        rc = lib.srt_window_attn(qkv.data_ptr(), bias.data_ptr(),
                                 out.data_ptr(), f, height, width, heads, hd,
                                 ldi, ldo, shift, hd ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"window_attn kernel launch failed: "
                           f"{lib.srt_error_string(rc).decode()} ({rc})")
    LAUNCHES += 1
    return out
