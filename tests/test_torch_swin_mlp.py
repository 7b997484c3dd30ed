"""SwinIR's MLP in one pass (`ops.cuda.swin_mlp`): its plain version against
PyTorch's composition; the fast tier's block running through it; the
widths the kernel takes and the wrapper's refusals, with no fallback; the
kernel's device code on the host against the plain version.  The tests
marked ``cuda`` hold the kernel to its plain version on the card:

    python -m pytest --noconftest tests/test_torch_swin_mlp.py -q -m cuda

Tolerance (`_close`), kernel against plain version, on bf16 ``y``: every
element within one bf16 unit of the plain value plus 2^-6, and, on 10,000
elements or more, the mean gap at most 2e-5 of the mean |y|.  Sound runs
differ only by the order of the f32 sums: that moves ``y``'s own rounding
by one unit, and flips a rare rounding of the hidden ``g``, which moves a
``y`` by |W2| times a unit of ``g`` (2^-6 holds two such flips at |W2| up
to 1/4 and |g| up to 8).  Measured: float64 sums (the witness below)
1.04e-3 past one unit and a mean of 1.2e-6 of the mean |y| on 3.6 M
elements at C = 180; the kernel on the card 2.4e-3 to 5.4e-3 past one
unit and 1.8e-7 to 3.4e-6 of the mean over 522,240 rows at C = 24, 180
and 240 (PERF.md).  The planted faults it must refuse: tanh GELU in place
of erf (a mean of 6.4e-4 to 8.4e-4 of the mean |y| on the card, 8e-4
here) and a dropped b1 (0.19 past one unit; a mean of 5e-2).
"""

import ctypes
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import swinir_reference as ref  # noqa: E402

from rusty_sr_tpu_torch.models import swinir  # noqa: E402
from rusty_sr_tpu_torch.ops.cuda import swin_mlp as sm  # noqa: E402

BF16 = torch.bfloat16
# SwinIR-S / the tests' small net, SwinIR-M, SwinIR-L's width
WIDTHS = [(24, 48), (180, 360), (240, 480)]


def _weights(c, hidden, seed, device="cpu"):
    """Weights drawn as the benchmark draws them (N(0, 1/fan_in), biases
    N(0, 0.05^2)), in bf16 as the fast tier holds them."""
    g = torch.Generator().manual_seed(seed)
    w1 = torch.randn(hidden, c, generator=g) / c ** 0.5
    b1 = 0.05 * torch.randn(hidden, generator=g)
    w2 = torch.randn(c, hidden, generator=g) / hidden ** 0.5
    b2 = 0.05 * torch.randn(c, generator=g)
    return [t.to(device, BF16) for t in (w1, b1, w2, b2)]


def _rows(n, c, seed, device="cpu"):
    """A LayerNorm's output: about N(0, 1)."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, c, generator=g).to(device, BF16)


def _mlp(c, hidden, seed, device="cpu"):
    w1, b1, w2, b2 = _weights(c, hidden, seed, device)
    return sm.prepare((w1, b1), (w2, b2))


def _composition(h, mlp, dtype=torch.float32, approximate="none",
                 bias1=True):
    """fc1, GELU and fc2 as the module states them: sums in ``dtype``, the
    biases added in it, GELU in f32, g rounded once, y rounded."""
    (w1, b1), (w2, b2) = mlp["fc1"], mlp["fc2"]
    s = F.linear(h.to(dtype), w1.to(dtype), b1.to(dtype) if bias1 else None)
    g = F.gelu(s.float(), approximate=approximate).to(BF16)
    return F.linear(g.to(dtype), w2.to(dtype), b2.to(dtype)).to(BF16)


def _unit(v: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place at each of ``v``'s magnitudes."""
    e = torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e) * torch.finfo(BF16).eps


def _close(y_k: torch.Tensor, y_p: torch.Tensor) -> bool:
    """``y_k`` against the plain ``y_p`` (see the module)."""
    yk, yp = y_k.float(), y_p.float()
    d = (yk - yp).abs()
    if bool((d > _unit(yp) + 2.0 ** -6).any()):
        return False
    return d.numel() < 10000 or float(d.mean()) <= 2e-5 * float(
        yp.abs().mean())


@pytest.mark.parametrize("c,hidden", WIDTHS)
@pytest.mark.parametrize("n", [1, 37, 1001])
def test_reference_is_the_composition(c, hidden, n):
    mlp = _mlp(c, hidden, c + n)
    h = _rows(n, c, n)
    y = sm.swin_mlp_reference(h, mlp)
    assert y.dtype == BF16 and y.shape == h.shape
    assert torch.equal(y, _composition(h, mlp))
    # the wrapper takes the plain version on the CPU, leading dims kept
    h3 = h.view(1, n, c)
    assert torch.equal(sm.swin_mlp(h3, mlp), y.view(1, n, c))


def test_reference_rounds_the_hidden_once():
    """One bf16 rounding of g, against the two of fc1's bf16 output
    before GELU: the latter is far from the float64 composition, the plain
    version one unit at most."""
    mlp = _mlp(180, 360, 3)
    h = _rows(2000, 180, 4)
    y = sm.swin_mlp_reference(h, mlp)
    exact = _composition(h, mlp, torch.float64)
    (w1, b1), (w2, b2) = mlp["fc1"], mlp["fc2"]
    twice = F.linear(F.gelu(F.linear(h, w1, b1)), w2, b2)
    assert _close(y, exact)
    assert not _close(twice, exact)


def test_tolerance_refuses_the_planted_faults():
    """At SwinIR-M's widths on 20,000 rows: sums in float64 (a sound
    change of sum order) pass; tanh GELU and a dropped b1 fail."""
    mlp = _mlp(180, 360, 180)
    h = _rows(20000, 180, 5)
    y = sm.swin_mlp_reference(h, mlp)
    assert _close(_composition(h, mlp, torch.float64), y)
    assert not _close(_composition(h, mlp, approximate="tanh"), y)
    assert not _close(_composition(h, mlp, bias1=False), y)


def test_prepare_pads_with_zeros():
    """C = 180 to 192, hidden 360 to 384: six chunks of two stages of
    192 x 64 bf16; the padded biases hold zeros."""
    mlp = _mlp(180, 360, 1)
    assert mlp["image"].dtype == BF16 and mlp["image"].is_contiguous()
    assert mlp["image"].numel() == 6 * 2 * 192 * 64
    assert mlp["bias1"].dtype == torch.float32
    assert mlp["bias1"].shape == (384,) and mlp["bias2"].shape == (192,)
    assert not mlp["bias1"][360:].any() and not mlp["bias2"][180:].any()
    assert torch.equal(mlp["bias1"][:360], mlp["fc1"][1].float())
    # the image holds each weight once and zeros besides
    w = torch.cat([mlp["fc1"][0].flatten(), mlp["fc2"][0].flatten()])
    img = mlp["image"]
    assert torch.equal(torch.sort(img[img != 0].float()).values,
                       torch.sort(w[w != 0].float()).values)


def test_prepare_refuses_mismatched_weights():
    w1, b1, w2, b2 = _weights(24, 48, 1)
    with pytest.raises(ValueError):
        sm.prepare((w1, b1), (w2.t(), b2))
    with pytest.raises(ValueError):
        sm.prepare((w1, b1[:40]), (w2, b2))


# --- the fast tier's block ---

CFG = dict(embed_dim=24, in_chans=3, depths=[2, 2], num_heads=[3, 3],
           window_size=8, mlp_ratio=2, num_feat=16, upscale=4, out_chans=3,
           img_size=64, img_range=1.0, mean=[0.4488, 0.4371, 0.4040])


@pytest.mark.parametrize("fast", [True, False])
def test_block_runs_through_the_op_in_the_fast_tier(monkeypatch, fast):
    """The fast tier calls the op once a block (4 for 2 groups of 2), its
    output unchanged by the spy; the exact tier never does, and keeps its
    f32 ``F.linear`` and ``F.gelu``."""
    tree = ref.draw_weights(2 ** 31 + 11, CFG)
    frames = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (1, 16, 16, 3), dtype=np.uint8))
    net = swinir.prepare(tree, "cpu", fast)
    want = swinir.forward(net, frames, to_u8=False)
    calls, gelus = [], [0]
    op, gelu = sm.swin_mlp, F.gelu

    def spy(h, mlp):
        calls.append(tuple(h.shape))
        return op(h, mlp)

    def count_gelu(*a, **k):
        gelus[0] += 1
        return gelu(*a, **k)

    monkeypatch.setattr(sm, "swin_mlp", spy)
    monkeypatch.setattr(F, "gelu", count_gelu)
    out = swinir.forward(net, frames, to_u8=False)
    assert torch.equal(out, want)
    if fast:
        assert calls == [(1, 16 * 16, 24)] * 4
        assert all("mlp" in b and "fc1" not in b
                   for layer in net["layers"] for b in layer["blocks"])
    else:
        assert calls == [] and gelus[0] == 4


# --- the widths the kernel takes, and the wrapper on CUDA tensors ---

class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: the wrapper's choices on
    the card, without one."""

    @property
    def device(self):
        return torch.device("cuda")


def _cuda_view(t):
    return torch.Tensor._make_subclass(_OnCuda, t)


def _on_cuda(mlp):
    return {k: (tuple(_cuda_view(t) for t in v) if isinstance(v, tuple)
                else _cuda_view(v)) for k, v in mlp.items()}


@pytest.mark.parametrize("c,hidden,takes", [
    (24, 48, True), (180, 360, True), (240, 480, True), (256, 512, True),
    (4, 8, True), (90, 360, False), (182, 360, False), (260, 512, False),
    (180, 520, False), (180, 364, False), (180, 4, False)])
def test_kernel_takes_the_widths(c, hidden, takes):
    mlp = _mlp(c, hidden, 1)
    h = _rows(3, c, 1)
    assert not sm.kernel_takes(h, mlp)                # a CPU tensor
    assert sm.kernel_takes(_cuda_view(h), mlp) == takes


@pytest.mark.parametrize("c,hidden", [(90, 360), (260, 512), (180, 520),
                                      (180, 364)])
def test_wrapper_raises_on_cuda_for_refused_widths(monkeypatch, c, hidden):
    """No fallback: a CUDA tensor of a width the kernel refuses raises,
    and the plain version is never called."""
    def no_fallback(*a):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(sm, "swin_mlp_reference", no_fallback)
    mlp = _on_cuda(_mlp(c, hidden, 2))
    with pytest.raises(ValueError, match="kernel takes"):
        sm.swin_mlp(_cuda_view(_rows(5, c, 2)), mlp)


def _bad_calls():
    mlp = _mlp(24, 48, 4)
    h = _rows(8, 24, 4)
    return {
        "h f32": (TypeError, lambda: sm.swin_mlp(h.float(), mlp)),
        "scalar h": (TypeError, lambda: sm.swin_mlp(torch.tensor(1.0), mlp)),
        "h width": (ValueError, lambda: sm.swin_mlp(h[:, :20].contiguous(),
                                                    mlp)),
        "h strided": (ValueError, lambda: sm.swin_mlp(
            torch.zeros(48, 24, dtype=BF16)[::2], mlp)),
        "h device": (ValueError, lambda: sm.swin_mlp(h.to("meta"), mlp)),
        "weights device": (ValueError, lambda: sm.swin_mlp(
            h, dict(mlp, image=mlp["image"].to("meta")))),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_wrapper_raises(case):
    err, call = _bad_calls()[case]
    with pytest.raises(err):
        call()


# --- the kernel's device code on the host ---

# One OS thread per CUDA thread with the conv stage's Hopper stand-ins
# (tests/test_torch_conv_stage.py), plus: the 8-byte cp.async a copy with
# zero fill, the bulk store a memcpy, setmaxnreg nothing, the named
# warpgroup barrier a barrier of its 128 threads, the turn barriers named
# barriers of 256 arrivals (bar.arrive counts without waiting), and the
# wgmma with A from registers a product that gathers the warpgroup's A
# fragments (m64nNk16: warp w holds rows 16w..16w+15, each thread {row g,
# g + 8} x {cols 2t, 2t + 1, 2t + 8, 2t + 9} packed in pairs) and reads B
# through its descriptor.
_MLP_TAIL = r"""
static void cp_async8(void* dst, const void* src, int n) {
  std::memset(dst, 0, 8);
  std::memcpy(dst, src, n);
}
static void cp_async_commit() {}
static void cp_async_wait_all() {}
static void wg_sync(int wg) { wg_bars[wg].wait(); }
// A named barrier of 256 arrivals: bar.sync counts and waits, bar.arrive
// counts and goes on.
class NamedBar {
 public:
  void arrive() {
    std::lock_guard<std::mutex> lk(m_);
    step();
  }
  void sync() {
    std::unique_lock<std::mutex> lk(m_);
    const long gen = gen_;
    step();
    cv_.wait(lk, [&] { return gen_ != gen; });
  }
 private:
  void step() {
    if (++count_ == 256) {
      count_ = 0;
      ++gen_;
      cv_.notify_all();
    }
  }
  std::mutex m_;
  std::condition_variable cv_;
  int count_ = 0;
  long gen_ = 0;
};
static NamedBar* turn_bars;
static void turn_wait(int wg) { turn_bars[wg].sync(); }
static void turn_pass(int wg) { turn_bars[1 - wg].arrive(); }
static uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__float2bfloat16(lo).bits |
         ((uint32_t)__float2bfloat16(hi).bits << 16);
}
template <int N> static void fence_frag(uint32_t*) {}
template <int N> static void regs_dec() {}
template <int N> static void regs_inc() {}
struct uint2 { unsigned x, y; };
static void bulk_store(void* dst, const void* src, uint32_t bytes) {
  std::memcpy(dst, src, bytes);
}
static void bulk_commit() {}
static void bulk_wait_read() {}
static void bulk_wait_all() {}
static uint32_t ra_regs[2][128][4];
static float ra_at(int wgi, int row, int k) {
  const int g = row % 8, hi = (row % 16) / 8, t = (k % 8) / 2;
  const uint32_t r =
      ra_regs[wgi][(row / 16) * 32 + g * 4 + t][hi + 2 * (k / 8)];
  const uint32_t u = ((r >> (16 * (k % 2))) & 0xffffu) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
template <int NI>
static void wgmma_bf16_ra(float* d, const uint32_t* a, uint64_t db) {
  const int wgi = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  std::memcpy(ra_regs[wgi][t], a, 16);
  wg_bars[wgi].wait();
  for (int i = 0; i < NI / 2; ++i) {
    const int row = 16 * warp + lane / 4 + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
    double s = 0.0;
    for (int k = 0; k < 16; ++k)
      s += (double)ra_at(wgi, row, k) * desc_at(db, col, k);
    d[i] = (float)((double)d[i] + s);
  }
  wg_bars[wgi].wait();
}
#include "swin_mlp.cu"
namespace { alignas(128) unsigned char mlp_smem[1 << 18]; }
static unsigned char* smem_base() { return mlp_smem; }
template <int CP>
static void run_block(const void* h, const void* w, const float* b1,
                      const float* b2, void* y, long long rows, int c,
                      int chunks) {
  swin_mlp_kernel<CP>(static_cast<const __nv_bfloat16*>(h),
                      static_cast<const __nv_bfloat16*>(w), b1, b2,
                      static_cast<__nv_bfloat16*>(y), rows, c, chunks);
}
extern "C" int host_swin_mlp(const void* h, const void* w, const float* b1,
                             const float* b2, void* y, long long rows, int c,
                             int cp, int chunks, int grid) {
  const MlpPlan pl = mlp_plan(cp);
  if (pl.smem > sizeof(mlp_smem) || pl.slots < 2) return 1;
  Barrier bar(MLP_THREADS), cbar(MLP_CONSUMERS);
  Barrier wgb[2] = {Barrier(128), Barrier(128)};
  block_bar = &bar;
  cons_bar = &cbar;
  wg_bars = wgb;
  blockDim = {(unsigned)MLP_THREADS, 1, 1};
  gridDim = {(unsigned)grid, 1, 1};
  for (int b = 0; b < grid; ++b) {
    // NaN bf16 everywhere: a read of shared memory that no copy wrote
    // poisons the result.
    std::memset(mlp_smem, 0xff, pl.smem);
    blockIdx = {(unsigned)b, 0, 0};
    // a block's barriers start afresh
    NamedBar turns[2];
    turn_bars = turns;
    std::vector<std::thread> th;
    for (int i = 0; i < MLP_THREADS; ++i)
      th.emplace_back([=] {
        threadIdx = {(unsigned)i, 0, 0};
        switch (cp) {
          case 32: run_block<32>(h, w, b1, b2, y, rows, c, chunks); break;
          case 64: run_block<64>(h, w, b1, b2, y, rows, c, chunks); break;
          case 192: run_block<192>(h, w, b1, b2, y, rows, c, chunks); break;
          case 256: run_block<256>(h, w, b1, b2, y, rows, c, chunks); break;
        }
      });
    for (auto& t : th) t.join();
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_mlp(tmp_path_factory):
    from test_torch_conv_stage import _HOPPER_STANDINS
    from test_torch_trunk import _compile_shim
    lib = _compile_shim(tmp_path_factory, "host_swin_mlp",
                        _HOPPER_STANDINS + _MLP_TAIL, ["-pthread"])
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.host_swin_mlp.argtypes = ([ptr] * 5 + [ctypes.c_longlong]
                                  + [i32] * 4)
    lib.host_swin_mlp.restype = i32
    return lib


def host_run(lib, h, mlp, grid):
    """The kernel's device code on the host over ``grid`` blocks (each
    walks tiles grid apart, as the persistent grid does on the card), y
    starting as NaN bits."""
    c = h.shape[-1]
    y = torch.full_like(h, float("nan"))
    assert lib.host_swin_mlp(
        h.data_ptr(), mlp["image"].data_ptr(), mlp["bias1"].data_ptr(),
        mlp["bias2"].data_ptr(), y.data_ptr(), h.numel() // c, c,
        mlp["bias2"].numel(), mlp["bias1"].numel() // sm.NC, grid) == 0
    return y


# (C, hidden, rows, grid): C padded in K and N (24 -> 32, 60 -> 64, 180
# -> 192), the hidden padded (48 -> 64, 40 -> 64, 360 -> 384); fc2's N in
# one piece (32, 64) and two (128 + 64, 128 + 128); one row, ragged
# tiles, and blocks that walk several tiles.
HOST_CASES = [(24, 48, 1, 1), (24, 48, 127, 1), (24, 48, 300, 2),
              (60, 40, 129, 1), (180, 360, 129, 1), (256, 512, 70, 1)]


@pytest.mark.parametrize("c,hidden,n,grid", HOST_CASES,
                         ids=[f"{c}-{hd}-{n}x{g}" for c, hd, n, g in
                              HOST_CASES])
def test_kernel_device_code_on_the_host(host_mlp, c, hidden, n, grid):
    mlp = _mlp(c, hidden, c * n)
    h = _rows(n, c, n)
    y = host_run(host_mlp, h, mlp, grid)
    assert not bool(torch.isnan(y.float()).any())
    assert _close(y, sm.swin_mlp_reference(h, mlp))


# --- on the card ---

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("c,hidden", [(24, 48), (180, 360)])
@pytest.mark.parametrize("n", [1, 127, 129, 544 * 960])
def test_kernel_matches_plain(cuda_device, c, hidden, n):
    """The tests' small width and SwinIR-M's, on row counts that fill no
    whole tile and on the cell's 544 x 960 padded tokens."""
    mlp = _mlp(c, hidden, c + n, cuda_device)
    h = _rows(n, c, n, cuda_device)
    launches = sm.LAUNCHES
    y = sm.swin_mlp(h, mlp)
    torch.cuda.synchronize()
    assert sm.LAUNCHES == launches + 1
    assert y.shape == h.shape and y.dtype == BF16
    assert _close(y, sm.swin_mlp_reference(h, mlp))


@pytest.mark.cuda
def test_kernel_refuses_a_strided_h(cuda_device):
    mlp = _mlp(180, 360, 1, cuda_device)
    h = _rows(64, 360, 1, cuda_device)[:, :180]
    with pytest.raises(ValueError, match="contiguous"):
        sm.swin_mlp(h, mlp)
    with pytest.raises(ValueError, match="kernel takes"):
        sm.swin_mlp(_rows(4, 90, 1, cuda_device), _mlp(90, 360, 1,
                                                       cuda_device))
