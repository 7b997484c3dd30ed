"""SwinIR's MLP in one pass: fc1, exact GELU and fc2 on rows of C channels.

Replaces no TPU kernel (the JAX package runs no transformer).
`swin_mlp` runs the hand-written CUDA kernel `csrc/swin_mlp.cu` on CUDA
tensors, and raises for widths the kernel refuses (`kernel_takes`), and
`swin_mlp_reference`, its plain version, on CPU tensors.

Both take ``h`` (..., C) bf16 and the weights as `prepare` lays them out
once, from fc1 = (W1 (hidden, C), b1) and fc2 = (W2 (C, hidden), b2), and
return a fresh ``y`` (..., C) bf16:

    g = GELU(h W1^T + b1), f32 sums, the bias added in f32, erf GELU in
        f32, rounded once to bf16
    y = g W2^T + b2, f32 sums, rounded to bf16

The plain version is PyTorch's composition on f32 copies (``F.linear``,
``F.gelu``, the casts); the kernel sums the same products in another
order.  `LAUNCHES` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

LAUNCHES = 0
NC = 64              # hidden columns a chunk of the kernel
MAX_C = 256          # fc2's wgmma N, and Y's registers
MAX_HIDDEN = 512


def _padded(n: int, m: int) -> int:
    return -(-n // m) * m


def prepare(fc1, fc2) -> dict:
    """The MLP's weights in both forms: ``fc1`` and ``fc2`` as given (the
    plain version's), and the kernel's: ``image``, the shared-memory
    images of its B operands in the order it reads them (per chunk of `NC`
    hidden columns, fc1's as [CP/16 k16 steps][2][NC][8] then fc2's as
    [NC/16][2][CP][8], CP = C rounded up to 32, zeros in the padding), and
    ``bias1`` (hidden padded to NC) and ``bias2`` (CP) in f32."""
    (w1, b1), (w2, b2) = fc1, fc2
    hidden, c = w1.shape
    if tuple(w2.shape) != (c, hidden) or b1.shape != (hidden,) \
            or b2.shape != (c,):
        raise ValueError(f"fc1 {tuple(w1.shape)} and fc2 {tuple(w2.shape)} "
                         "are not (hidden, C) and (C, hidden) with biases")
    cp, hp = _padded(c, 32), _padded(hidden, NC)
    chunks = hp // NC
    dt, dev = torch.bfloat16, w1.device
    w1p = torch.zeros(hp, cp, dtype=dt, device=dev)
    w1p[:hidden, :c] = w1
    w2p = torch.zeros(cp, hp, dtype=dt, device=dev)
    w2p[:c, :hidden] = w2
    # (chunk, k16 step, k8 half, column, 8)
    f1 = w1p.view(chunks, NC, cp // 16, 2, 8).permute(0, 2, 3, 1, 4)
    f2 = w2p.view(cp, chunks, NC // 16, 2, 8).permute(1, 2, 3, 0, 4)
    image = torch.stack([f1.reshape(chunks, -1), f2.reshape(chunks, -1)],
                        1).reshape(-1).contiguous()
    bias1 = torch.zeros(hp, device=dev)
    bias1[:hidden] = b1.float()
    bias2 = torch.zeros(cp, device=dev)
    bias2[:c] = b2.float()
    return {"fc1": (w1, b1), "fc2": (w2, b2), "image": image,
            "bias1": bias1, "bias2": bias2}


def kernel_takes(h: torch.Tensor, mlp: dict) -> bool:
    """True where the kernel takes ``h`` and the weights: a CUDA tensor of
    rows of C channels, C a multiple of 4 up to `MAX_C` (rows of 8-byte
    pieces, fc2's N and its accumulators), and a hidden width that is a
    multiple of 8 up to `MAX_HIDDEN` (the widths the kernel is held to)."""
    c = h.shape[-1] if h.dim() else 0
    hidden = mlp["fc1"][0].shape[0]
    return (h.device.type == "cuda" and c % 4 == 0 and 4 <= c <= MAX_C
            and hidden % 8 == 0 and 8 <= hidden <= MAX_HIDDEN)


def swin_mlp_reference(h: torch.Tensor, mlp: dict) -> torch.Tensor:
    """The plain version (see the module), on any device and any width."""
    (w1, b1), (w2, b2) = mlp["fc1"], mlp["fc2"]
    g = F.gelu(F.linear(h.float(), w1.float(), b1.float()))
    return F.linear(g.to(torch.bfloat16).float(), w2.float(),
                    b2.float()).to(torch.bfloat16)


def _check(h: torch.Tensor, mlp: dict) -> None:
    if h.dim() < 1 or h.dtype != torch.bfloat16:
        raise TypeError(f"h must be bf16 (..., C), got {h.dtype} "
                        f"{tuple(h.shape)}")
    (w1, b1), (w2, b2) = mlp["fc1"], mlp["fc2"]
    if w1.shape[1] != h.shape[-1]:
        raise ValueError(f"h has {h.shape[-1]} channels, fc1 takes "
                         f"{w1.shape[1]}")
    ts = [h, w1, b1, w2, b2, mlp["image"], mlp["bias1"], mlp["bias2"]]
    if any(t.device != h.device for t in ts):
        raise ValueError(f"every tensor must be on h's device {h.device}")
    if not h.is_contiguous():
        raise ValueError("h must be contiguous")


def swin_mlp(h: torch.Tensor, mlp: dict) -> torch.Tensor:
    """y of the module's contract, from `prepare`'s weights.  CPU tensors
    take `swin_mlp_reference`; CUDA tensors launch ``swin_mlp_kernel`` on
    the current stream (no synchronisation) and raise for widths that
    `kernel_takes` refuses."""
    global LAUNCHES
    _check(h, mlp)
    if h.device.type == "cpu":
        return swin_mlp_reference(h, mlp)
    if h.device.type != "cuda":
        raise ValueError(f"swin_mlp runs on cpu or cuda, not {h.device}")
    if not kernel_takes(h, mlp):
        raise ValueError(
            f"the kernel takes C a multiple of 4 up to {MAX_C} and a hidden "
            f"width a multiple of 8 up to {MAX_HIDDEN}, not "
            f"{h.shape[-1]} and {mlp['fc1'][0].shape[0]}")
    c = h.shape[-1]
    y = torch.empty_like(h)
    if h.numel() == 0:
        return y
    if h.data_ptr() % 8:
        raise ValueError("h must start on an 8-byte boundary")
    from rusty_sr_tpu_torch.ops.cuda import _build
    lib = _build.load()
    with torch.cuda.device(h.device):
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(h.device).cuda_stream)
        rc = lib.srt_swin_mlp(
            h.data_ptr(), mlp["image"].data_ptr(), mlp["bias1"].data_ptr(),
            mlp["bias2"].data_ptr(), y.data_ptr(), h.numel() // c, c,
            mlp["bias2"].numel(), mlp["bias1"].numel() // NC, stream)
    if rc != 0:
        raise RuntimeError(f"swin_mlp kernel launch failed: "
                           f"{lib.srt_error_string(rc).decode()} ({rc})")
    LAUNCHES += 1
    return y
