"""HAT's two attentions on token-major activations: the shifted-window
self-attention of its hybrid attention blocks (`sa_attn`) and the
overlapping cross-attention of its OCAB (`oca_attn`).

Replaces no TPU kernel (the JAX package runs no attention).  On CUDA
tensors `sa_attn` launches ``hat_sa16_kernel`` and `oca_attn`
``hat_oca_kernel`` (`csrc/hat_attn.cu`, one body templated on the key
window), which take 16x16 windows and 16x16 or 24x24 keys and raise for
other shapes; on CPU tensors both run `hat_attn_reference`, their plain
version, at any window, which the exact tier of `models.hat` calls on
any device.

Both take ``qkv`` (frames, P*Q, 3*C), the `qkv` projection's output in
HAT's channel order (part*C + head*hd + d, part q/k/v; wider rows, whose
first 3*C channels are read, with ``channels`` = C), and ``table``
(heads, TW*TW) f32, the block's relative-position table laid out by the
key's offset from the query inside their windows (`offset_table`, TW =
window + key window - 1), and return (frames, P*Q, C) in the grid's own
token order (rows of ``out_width`` with zero columns after C, where
given), ``softmax(q k^T * hd^-0.5 + bias (+ mask)) v`` per window and
head:
- `sa_attn`: the grid rolled by (-shift, -shift), cut into window x
  window squares, each attending to itself; the mask is Swin's
  `calculate_mask` for a P x Q grid (`window_attn.shift_mask`); the
  windows merged and rolled back;
- `oca_attn`: queries from each window, keys and values from the
  key_window x key_window square centred on it (`nn.Unfold(key_window,
  stride=window, padding=(key_window - window) / 2)`), zeros outside the
  grid, which score their bias and add nothing to the sum of values.
`LAUNCHES_SA` and `LAUNCHES_OCA` count the kernels' launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from rusty_sr_tpu_torch.ops.cuda.window_attn import relative_index, shift_mask

KERNEL_WINDOW = 16          # the kernels' query window
KERNEL_KEY_WINDOWS = (16, 24)
WINDOWS_A_BLOCK = 256       # the plain version's windows per product
LAUNCHES_SA = 0
LAUNCHES_OCA = 0


def _offsets(window: int, key_window: int) -> tuple:
    """(dy, dx), each (w*w, kw*kw): key minus query row and column, for
    query i of a window and key j of the key_window square (its first
    row and column at the query window's), inside their own squares."""
    yq, xq = torch.meshgrid(torch.arange(window), torch.arange(window),
                            indexing="ij")
    yk, xk = torch.meshgrid(torch.arange(key_window),
                            torch.arange(key_window), indexing="ij")
    return (yk.reshape(1, -1) - yq.reshape(-1, 1),
            xk.reshape(1, -1) - xq.reshape(-1, 1))


def overlap_index(window: int, key_window: int) -> torch.Tensor:
    """(w*w, kw*kw) int64: HAT's `calculate_rpi_oca`, the row of the
    (w + kw - 1)^2 table for query i of a window and key j of the square
    around it, as published: (yk - yq + w - kw + 1) * (w + kw - 1) + (xk
    - xq + w - kw + 1), negative for some pairs (PyTorch's indexing wraps
    them)."""
    dy, dx = _offsets(window, key_window)
    off = window - key_window + 1
    return (dy + off) * (window + key_window - 1) + dx + off


def _slots(window: int, key_window: int) -> torch.Tensor:
    """(w*w, kw*kw): the offset-table slot of each (query, key) pair,
    (yk - yq + w - 1) * TW + (xk - xq + w - 1)."""
    dy, dx = _offsets(window, key_window)
    return (dy + window - 1) * (window + key_window - 1) + dx + window - 1


def offset_table(table: torch.Tensor, window: int,
                 key_window: int) -> torch.Tensor:
    """A block's (rows, heads) relative-position table -> (heads, TW*TW)
    float32 by the key's offset from the query: the self-attention's
    (key_window == window) through Swin's index, the cross-attention's
    through `overlap_index` with negative rows wrapped as PyTorch wraps
    them.  ValueError for a table of another size."""
    tw = window + key_window - 1
    if table.dim() != 2 or table.shape[0] != tw * tw:
        raise ValueError(f"a {window}/{key_window} window's table has "
                         f"{tw * tw} rows, not {tuple(table.shape)}")
    if key_window == window:
        idx = relative_index(window)
    else:
        idx = overlap_index(window, key_window) % (tw * tw)
    out = torch.empty(tw * tw, table.shape[1], dtype=torch.float32,
                      device=table.device)
    slots = _slots(window, key_window).reshape(-1).to(table.device)
    out[slots] = table.float()[idx.reshape(-1).to(table.device)]
    return out.t().contiguous()


def bias_of(tab: torch.Tensor, window: int, key_window: int) -> torch.Tensor:
    """(heads, TW*TW) offset table -> (heads, w*w, kw*kw) bias."""
    slots = _slots(window, key_window).to(tab.device)
    return tab[:, slots]


def hat_attn_reference(qkv: torch.Tensor, tab: torch.Tensor, shift: int,
                       height: int, width: int, window: int,
                       key_window: int, channels=None,
                       out_width=None) -> torch.Tensor:
    """The plain version: roll, window partition (the keys of the
    overlapping form cut from the zero-padded grid by `Tensor.unfold`),
    attention in float32 over blocks of windows (q scaled first, then
    bias, then mask, as HAT orders them), merge, roll back; the result in
    ``qkv``'s dtype."""
    f, n = qkv.shape[:2]
    c = channels or qkv.shape[2] // 3
    heads, ws, kw = tab.shape[0], window, key_window
    hd = c // heads
    wy, wx = height // ws, width // ws
    x = qkv[..., :3 * c].float().reshape(f, height, width, 3 * c)
    if shift:
        x = torch.roll(x, (-shift, -shift), (1, 2))

    def windows(t):         # (f, P, Q, C) -> (windows, heads, ws*ws, hd)
        return t.reshape(f, wy, ws, wx, ws, heads, hd) \
            .permute(0, 1, 3, 5, 2, 4, 6).reshape(-1, heads, ws * ws, hd)
    q = windows(x[..., :c]) * hd ** -0.5
    if kw == ws:
        k, v = windows(x[..., c:2 * c]), windows(x[..., 2 * c:])
    else:
        ov = (kw - ws) // 2
        kv = F.pad(x[..., c:], (0, 0, ov, ov, ov, ov))
        kv = kv.unfold(1, kw, ws).unfold(2, kw, ws)  # (f, wy, wx, 2C, kw, kw)
        kv = kv.reshape(f, wy, wx, 2, heads, hd, kw, kw) \
            .permute(3, 0, 1, 2, 4, 6, 7, 5).reshape(2, -1, heads, kw * kw,
                                                     hd)
        k, v = kv[0], kv[1]
    bias = bias_of(tab.float(), ws, kw)
    mask = shift_mask(height, width, shift, ws, qkv.device) if shift \
        else None
    o = torch.empty_like(q)
    for s in range(0, q.shape[0], WINDOWS_A_BLOCK):
        e = min(s + WINDOWS_A_BLOCK, q.shape[0])
        attn = q[s:e] @ k[s:e].transpose(-2, -1) + bias
        if mask is not None:
            attn = attn + mask[torch.arange(s, e, device=qkv.device)
                               % (wy * wx)].unsqueeze(1)
        o[s:e] = torch.softmax(attn, dim=-1) @ v[s:e]
    o = o.reshape(f, wy, wx, heads, ws, ws, hd) \
        .permute(0, 1, 4, 2, 5, 3, 6).reshape(f, height, width, c)
    if shift:
        o = torch.roll(o, (shift, shift), (1, 2))
    o = o.reshape(f, n, c).to(qkv.dtype)
    return o if out_width in (None, c) else F.pad(o, (0, out_width - c))


def _check(qkv, tab, shift, height, width, window, key_window, channels,
           out_width) -> None:
    c = channels or (qkv.shape[-1] // 3 if qkv.dim() else 0)
    if qkv.dim() != 3 or qkv.shape[2] < 3 * c or c < 1 \
            or (channels is None and qkv.shape[2] % 3):
        raise ValueError(f"qkv must be (frames, tokens, 3*C), got "
                         f"{tuple(qkv.shape)}")
    if out_width is not None and out_width < c:
        raise ValueError(f"out_width {out_width} is under {c} channels")
    n = qkv.shape[1]
    if n != height * width or height % window or width % window:
        raise ValueError(f"{n} tokens are not a {height}x{width} grid of "
                         f"whole {window}x{window} windows")
    tw = window + key_window - 1
    if tab.dim() != 2 or tab.shape[1] != tw * tw or c % tab.shape[0]:
        raise ValueError(f"table {tuple(tab.shape)} does not fit {c} "
                         f"channels and {window}/{key_window} windows")
    if key_window < window or (key_window - window) % 2:
        raise ValueError(f"key window {key_window} does not centre on "
                         f"window {window}")
    if not 0 <= shift < window or (shift and key_window != window):
        raise ValueError(f"shift {shift} for {window}/{key_window} windows")


def _launch(qkv, tab, shift, height, width, window, key_window,
            channels=None, out_width=None):
    """``qkv`` through the kernel of ``key_window``, or its plain version
    on CPU tensors."""
    _check(qkv, tab, shift, height, width, window, key_window, channels,
           out_width)
    if qkv.device.type == "cpu":
        return hat_attn_reference(qkv, tab, shift, height, width, window,
                                  key_window, channels, out_width)
    if qkv.device.type != "cuda":
        raise ValueError(f"HAT's attention runs on cpu or cuda, not "
                         f"{qkv.device}")
    f, n, ldi = qkv.shape
    c, heads = channels or ldi // 3, tab.shape[0]
    hd, ldo = c // heads, out_width or c
    if window != KERNEL_WINDOW or key_window not in KERNEL_KEY_WINDOWS:
        raise ValueError(f"the kernels take window {KERNEL_WINDOW} with "
                         f"keys {KERNEL_KEY_WINDOWS}, not {window}/"
                         f"{key_window}")
    if qkv.dtype != torch.bfloat16 or tab.dtype != torch.float32:
        raise TypeError(f"the kernels take bf16 qkv and an f32 table, not "
                        f"{qkv.dtype} and {tab.dtype}")
    if hd % 2 or hd > 32 or ldi % 2 or ldo % 2:
        raise ValueError(f"the kernels take an even head width up to 32 and "
                         f"even rows, not {hd}, {ldi} and {ldo}")
    if not (qkv.is_contiguous() and tab.is_contiguous()):
        raise ValueError("qkv and the table must be contiguous")
    if tab.device != qkv.device:
        raise ValueError(f"the table is on {tab.device}, qkv on "
                         f"{qkv.device}")
    out = torch.empty((f, n, ldo), device=qkv.device, dtype=torch.bfloat16)
    if out.numel() == 0:
        return out
    from rusty_sr_tpu_torch.ops.cuda import _build
    lib = _build.load()
    with torch.cuda.device(qkv.device):
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(qkv.device).cuda_stream)
        rc = lib.srt_hat_attn(qkv.data_ptr(), tab.data_ptr(), out.data_ptr(),
                              f, height, width, heads, hd, ldi, ldo, shift,
                              key_window, hd ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"HAT attention kernel launch failed: "
                           f"{lib.srt_error_string(rc).decode()} ({rc})")
    return out


def sa_attn(qkv: torch.Tensor, tab: torch.Tensor, shift: int, height: int,
            width: int, window: int = KERNEL_WINDOW, channels=None,
            out_width=None) -> torch.Tensor:
    """The shifted-window self-attention (see the module): bf16 in and out
    through ``hat_sa16_kernel`` on the current stream (no
    synchronisation) on CUDA tensors, the plain version on CPU tensors."""
    global LAUNCHES_SA
    out = _launch(qkv, tab, shift, height, width, window, window, channels,
                  out_width)
    if qkv.device.type == "cuda" and out.numel():
        LAUNCHES_SA += 1
    return out


def oca_attn(qkv: torch.Tensor, tab: torch.Tensor, height: int, width: int,
             window: int = KERNEL_WINDOW, key_window: int = 24,
             channels=None, out_width=None) -> torch.Tensor:
    """The overlapping cross-attention (see the module): bf16 in and out
    through ``hat_oca_kernel`` on CUDA tensors, the plain version on CPU
    tensors."""
    global LAUNCHES_OCA
    out = _launch(qkv, tab, 0, height, width, window, key_window, channels,
                  out_width)
    if qkv.device.type == "cuda" and out.numel():
        LAUNCHES_OCA += 1
    return out
