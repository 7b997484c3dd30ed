"""One trunk conv stage with bf16 operands and f32 accumulation.

The contract of `rusty_sr_tpu/ops/conv.py::_conv_native` with bf16
operands and ``preferred_element_type=f32``, as the xla engine's fast
tiers call it (`parallel/tiling.py`): a stride-1 cross-correlation with
Same zero padding, NHWC bf16 input, HWIO bf16 weights of odd size, f32
accumulation, and an f32 output or one rounded to nearest-even bf16 (the
JAX code's ``cv(...).astype(bf16)``).

`conv_stage` runs the hand-written CUDA kernel `csrc/conv_stage.cu` (the
counterpart of the Pallas conv-stage probes `scripts/mosaic_probe*.py`)
on CUDA tensors, and `conv_stage_reference` on CPU tensors; on any other
device, or on a build or launch failure, it raises.  `LAUNCHES` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from rusty_sr_tpu_torch.ops.conv import exact_f32

# Launches of the CUDA kernel since the count was last set to 0.
LAUNCHES = 0

_OUT = (torch.float32, torch.bfloat16)


def conv_stage_reference(x: torch.Tensor, w: torch.Tensor,
                         out_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """The plain version.  float32 out: `F.conv2d` on float32 tensors that
    hold the bf16 values, TF32 off — products of two bf16 values are exact
    in f32, so only the order of the f32 sums differs from the kernel.
    bfloat16 out: a bf16 `F.conv2d` (f32 accumulation, one rounding of the
    output), the same values as the f32 form rounded once."""
    if out_dtype not in _OUT:
        raise ValueError(f"out_dtype must be float32 or bfloat16, not "
                         f"{out_dtype}")
    k = w.shape[0]
    xt = x.permute(0, 3, 1, 2)
    wt = w.permute(3, 2, 0, 1)
    if out_dtype == torch.bfloat16:
        y = F.conv2d(xt.to(torch.bfloat16), wt.to(torch.bfloat16),
                     padding=k // 2)
    else:
        with exact_f32():
            y = F.conv2d(xt.to(torch.bfloat16).float(),
                         wt.to(torch.bfloat16).float(), padding=k // 2)
    return y.permute(0, 2, 3, 1).contiguous()


def conv_stage(x: torch.Tensor, w: torch.Tensor,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Same-padded conv of bf16 ``x`` (B, H, W, Cin) with bf16 ``w`` (k, k,
    Cin, Cout), k odd, accumulated in f32 -> (B, H, W, Cout) of
    ``out_dtype`` (float32, or bfloat16 rounded to nearest-even).

    CPU tensors take `conv_stage_reference`; CUDA tensors launch the
    kernel on the current stream (no synchronisation)."""
    global LAUNCHES
    if out_dtype not in _OUT:
        raise ValueError(f"out_dtype must be float32 or bfloat16, not "
                         f"{out_dtype}")
    if x.device.type == "cpu":
        return conv_stage_reference(x, w, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"conv_stage runs on cpu or cuda, not {x.device}")
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} has dtype {t.dtype}, expected bfloat16")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-d, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    bsz, h, wd, cin = x.shape
    k, k2, wcin, cout = w.shape
    if k != k2 or k % 2 == 0 or wcin != cin:
        raise ValueError(f"weights {tuple(w.shape)} are not (k, k, {cin}, "
                         "Cout) with k odd")
    if bsz > 65535:
        raise ValueError(f"at most 65535 images a launch, got {bsz}")
    out = torch.empty((bsz, h, wd, cout), device=x.device, dtype=out_dtype)
    if out.numel() == 0 or cin == 0:
        return out.zero_()
    from rusty_sr_tpu_torch.ops.cuda import _build
    lib = _build.load()
    vec = int(cin % 8 == 0 and x.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.srt_conv_stage(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                bsz, h, wd, cin, cout, k,
                                int(out_dtype == torch.bfloat16), vec,
                                ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError("conv-stage kernel launch failed: "
                           f"{lib.srt_error_string(rc).decode()} ({rc})")
    LAUNCHES += 1
    return out
