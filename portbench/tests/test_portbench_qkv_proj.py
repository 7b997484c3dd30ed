"""`qkv_proj_roofline_pct.swinir`: the qkv and proj GEMMs' share of their
bound in the SwinIR cell, against a hand count, on kernel names as the
cell's traces carry them."""

import pytest

from portbench import harness
from portbench.tracing import Reading

CELL = "swinir_x4_frames_fast"
# cuBLAS's kernels for qkv and proj: sm80 `align2` on rows of 180, sm90
# `nvjet` on rows of whole 16-byte groups
GEMMS = [
    "void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_bf16_128x128"
    "_32x3_tn_align2>(cutlass_80_tensorop_bf16_s16816gemm_bf16_128x128_32x3"
    "_tn_align2::Params)",
    "void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_bf16_256x128"
    "_32x3_tn_align2>(cutlass_80_tensorop_bf16_s16816gemm_bf16_256x128_32x3"
    "_tn_align2::Params)",
    "nvjet_tst_192x192_64x4_1x2_h_bz_coopB_bias_TNN",
]
# cuDNN's convolutions and the program's own kernels
OTHERS = [
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize"
    "128x128x64_warpgroupsize1x1x1_execute_segment_k_off_kernel__5x_cudnn",
    "void (anonymous namespace)::window_attn_kernel<true>((anonymous "
    "namespace)::WaArgs)",
    "void (anonymous namespace)::swin_mlp_kernel<192>(const __nv_bfloat16 *,"
    " long long, int, int)",
    "nhwcAddPaddingKernel",
]


def _config():
    return harness.cell_files(harness.benchmark(), CELL)[1]


def _metric():
    return harness.load_module("metrics", "qkv_proj_roofline_pct.swinir")


def test_qkv_proj_bound_is_the_hand_count():
    """SwinIR-M, per padded token and block: qkv 2 * 180 * 540 and proj
    2 * 180 * 180 FLOP = 259,200; 180 bf16 read and 540 written by qkv,
    180 read and 180 written by proj = 2,160 bytes; 36 blocks."""
    mod, cfg = _metric(), _config()
    assert mod.flop_per_token(cfg) == 36 * 259_200
    assert mod.bytes_per_token(cfg) == 36 * 2_160


@pytest.mark.parametrize("name", GEMMS)
def test_gemm_kernels_count(name):
    r = Reading(1.0, [(name, 0.0, 0.25)], [], [], {"tokens": 1})
    assert _metric().gemm_s(r) == 0.25


@pytest.mark.parametrize("name", OTHERS)
def test_convolutions_and_the_programs_kernels_do_not(name):
    r = Reading(1.0, [(name, 0.0, 0.25)], [], [], {"tokens": 1})
    assert _metric().gemm_s(r) == 0.0


@pytest.mark.parametrize("tokens", [522240, 0])
def test_reads_none_without_a_gemm_or_tokens(tokens):
    mod, cfg = _metric(), _config()
    kernels = [(n, 0.0, 0.1) for n in OTHERS]
    if not tokens:
        kernels.append((GEMMS[2], 0.1, 0.2))
    r = Reading(1.0, kernels, [], [], {"tokens": tokens})
    r.config = cfg
    assert mod.read(r) is None


def test_reads_the_hand_counted_share():
    """One 544 x 960 frame, 36 blocks, each a qkv and a proj kernel of 0.3
    and 0.2 ms beside the others: 522,240 * 36 * 2,160 bytes at 3.35 TB/s
    (12.12 ms) over 18 ms; the FLOP (4.93 ms at 989 TFLOP/s) bound less."""
    mod, cfg = _metric(), _config()
    kernels = [(n, 0.0, 0.1) for n in OTHERS]
    for i in range(36):
        t = 0.2 + i * 0.001
        kernels += [(GEMMS[i % 2], t, t + 0.0003),
                    (GEMMS[2], t + 0.0005, t + 0.0007)]
    r = Reading(1.0, kernels, [], [], {"tokens": 522240, "lr_px": 518400})
    r.config = cfg
    nbytes = 522240 * 36 * 2160
    assert nbytes / 3.35e12 > 522240 * 36 * 259_200 / 989e12
    assert mod.read(r) == pytest.approx(100 * nbytes / 3.35e12 / 0.018,
                                        rel=1e-6)
