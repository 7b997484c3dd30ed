#!/usr/bin/env python3
"""The fused trunk kernel's variants, built side by side and timed in turns
on the card at the main path's shape (24 tiles of 256^2 padded, anime
weights, x3), each held against the plain version first.

    python3 scripts/trunk_variants.py [--old PATH]     # from the repo root

Each variant is `rusty_sr_tpu_torch/csrc/trunk.cu` compiled with the port's
nvcc flags (and, for some, one more) after text substitutions that change
a block-shape constant or take a piece of work out, into
``rusty_sr_tpu_torch/_build/variants/``.
``--old`` adds an earlier `trunk.cu` (the same C interface for f32; for
bf16 one that takes the five padded matrices) as the variant "old"; by
default ``rusty_sr_tpu_torch/_build/trunk_old.cu`` if it exists, e.g. from
``git show <commit>:rusty_sr_tpu_torch/csrc/trunk.cu``.

Prints, per mode, each variant's max and mean abs error against the plain
version and against the plain version with exact sums
(`fused_trunk_reference(..., exact_sums=True)`: float64 convolutions, so
the error of each side's own f32 sums shows) and a digest of its output
(equal digests, bit-identical outputs), then its ms per call (CUDA
events, 5 calls, in turns base, ..., ..., base); each build's ptxas
registers, spills and C7519/C7520 counts; the f32 values where the bf16
mode's square root (`sqrt_ge1`) differs from `sqrtf` (every y >= 1) and
where `belu_bf16` differs from `belu` (every f32 x at the anime weights'
slopes); how often the tensor cores' f32 sums and f32 FMA sums each put a
value on the other side of a bf16 rounding than exact sums do, on the
trunk's own activations; and the card's name and power limit.
"""

import argparse
import ctypes
import hashlib
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from rusty_sr_tpu_torch import params  # noqa: E402
from rusty_sr_tpu_torch.ops.cuda import _build, trunk  # noqa: E402

CSRC = os.path.join(ROOT, "rusty_sr_tpu_torch", "csrc")
OUT = os.path.join(_build.BUILD_DIR, "variants")

# Text substitutions that take one piece of work out of a variant (its
# output is then garbage; it only times what is left).  Every barrier
# arrival stays, so none can wait forever.
NO_MMA = ("        wgmma_bf16<NCH>(acc, da",
          "        if (pl.P < 0) wgmma_bf16<NCH>(acc, da")
NO_WEIGHTS = ("""            mbar_expect_tx(&full[slot], bytes);
            bulk_copy(sm + pl.ring + (size_t)slot * TB_SLOT,
                      img + base + (long long)n0 * 16 * nch, bytes, &full[slot]);""",
              """            (void)bytes;
            mbar_arrive(&full[slot]);""")
NO_EPILOGUE = ("    tb_pair<S>(pl, a, sm, vs, w,",
               "    if (pl.P < 0) tb_pair<S>(pl, a, sm, vs, w,")
NO_RING = [("      mbar_wait(&full[slot], (q / TB_SLOTS) & 1);\n      const int n0",
            "      const int n0"),
           ("    if (tid != TB_WGS * 128) return;", "    return;")]
NO_INPUT = ("  tb_input(pl, sm, x, mask,", "  if (n < 0) tb_input(pl, sm, x, mask,")
EMPTY = ("  // Phase 0 on every thread, ahead of the roles",
         "  if (n > 0) return;\n  // Phase 0 on every thread, ahead of the roles")
NO_EPILOGUE_CODE = ("    switch (s) {\n      case 0: tb_epilogue<0, NCH>",
                    "    if (pl.P < 0) switch (s) {\n      case 0: tb_epilogue<0, NCH>")
NO_FMA = ("      if (valid) {\n        const float* wb",
          "      if (valid && krows < 0) {\n        const float* wb")

# The earlier f32 block shape on the new FMA core: 8x8 blocks of 256 threads,
# two to an SM, 8 weight rows a chunk.
F32_8X8 = [("F_R = 12;", "F_R = 8;"), ("F_THREADS = 512;", "F_THREADS = 256;"),
           ("F_WCH = 32;", "F_WCH = 8;"),
           ("(F_THREADS, 1)", "(F_THREADS, 2)")]
# The bf16 epilogue's BeLU on sqrtf, as the f32 mode's.
IEEE_SQRT = ("  const float r = rsqrtf(y);",
             "  if (y >= 1.0f) return sqrtf(y);\n  const float r = rsqrtf(y);")

# nvcc's default -fmad=true lets ptxas fuse a product and a sum into an
# FMA where it chooses, so two builds of the same arithmetic can differ in
# the last bit; these builds fuse only the explicit fmaf.
NO_FMAD = ("-fmad=false",)

# name -> (mode, substitutions[, extra nvcc flags])
VARIANTS = {
    "f32 base": ("f32", ()),
    "f32 8x8 blocks": ("f32", F32_8X8),
    "f32 no fma": ("f32", (NO_FMA,)),
    "bf16 base": ("bf16", ()),
    "bf16 sqrtf": ("bf16", (IEEE_SQRT,)),
    "bf16 base, -fmad=false": ("bf16", (), NO_FMAD),
    "bf16 sqrtf, -fmad=false": ("bf16", (IEEE_SQRT,), NO_FMAD),
    "bf16 no mma": ("bf16", (NO_MMA,)),
    "bf16 no weights": ("bf16", (NO_WEIGHTS,)),
    "bf16 no epilogue": ("bf16", (NO_EPILOGUE,)),
    "bf16 skeleton": ("bf16", (NO_MMA, NO_WEIGHTS, NO_EPILOGUE)),
    "bf16 skeleton, no ring": ("bf16", (NO_MMA, NO_WEIGHTS, NO_EPILOGUE,
                                        *NO_RING)),
    "bf16 skeleton, no input": ("bf16", (NO_MMA, NO_WEIGHTS, NO_EPILOGUE,
                                         NO_INPUT)),
    "bf16 skeleton, no ring, no input, no epilogue code": (
        "bf16", (NO_MMA, NO_WEIGHTS, NO_EPILOGUE, NO_INPUT, *NO_RING,
                 NO_EPILOGUE_CODE)),
    "bf16 empty": ("bf16", (EMPTY,)),
}

# Counts, on the card, the f32 values where sqrt_ge1 differs from sqrtf
# (every y from 1 through inf and the NaNs) and where belu_bf16 differs
# from belu (every f32 x, at each slope); two NaNs count as equal.
SQRT_CHECK = r"""
#include "trunk.cu"
__device__ bool same(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b) || (a != a && b != b);
}
__global__ void sqrt_check(unsigned long long* bad, const float* slopes,
                           int np) {
  const unsigned long long t =
      blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
  const unsigned long long step = (unsigned long long)gridDim.x * blockDim.x;
  unsigned long long b0 = 0, b1 = 0;
  for (unsigned long long u = 0x3f800000ull + t; u <= 0x7fffffffull;
       u += step) {
    const float y = __uint_as_float((unsigned)u);
    b0 += !same(sqrt_ge1(y), sqrtf(y));
  }
  for (unsigned long long u = t; u <= 0xffffffffull; u += step) {
    const float x = __uint_as_float((unsigned)u);
    for (int k = 0; k < np; ++k)
      b1 += !same(belu_bf16(x, slopes[k]), belu(x, slopes[k]));
  }
  atomicAdd(&bad[0], b0);
  atomicAdd(&bad[1], b1);
}
extern "C" int run_sqrt_check(unsigned long long* bad, const float* slopes,
                              int np) {
  sqrt_check<<<132 * 16, 256>>>(bad, slopes, np);
  return (int)cudaDeviceSynchronize();
}
"""


def build(old: str | None) -> dict:
    os.makedirs(OUT, exist_ok=True)
    cmds, names = [], []
    with open(os.path.join(CSRC, "trunk.cu")) as f:
        src = f.read()
    for i, (name, (_, subs, *flags)) in enumerate(VARIANTS.items()):
        code = src
        for old_, new_ in subs:
            if old_ not in code:
                raise SystemExit(f"variant {name} no longer matches the "
                                 f"source: {old_!r}")
            code = code.replace(old_, new_)
        path = os.path.join(OUT, f"v{i}.cu")
        with open(path, "w") as f:
            f.write(code)
        cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, *sum(flags, ()),
                     "-shared", "-I", CSRC, "-o",
                     os.path.join(OUT, f"v{i}.so"), path])
        names.append(name)
    path = os.path.join(OUT, "sqrt_check.cu")
    with open(path, "w") as f:
        f.write(SQRT_CHECK)
    cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", CSRC,
                 "-o", os.path.join(OUT, "sqrt_check.so"), path])
    names.append("sqrt check")
    if old:
        cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                     CSRC, "-o", os.path.join(OUT, "old.so"), old])
        names.append("old")
    t0 = time.time()
    libs = {}
    for name, (cmd, rc, out) in zip(names, _build._run_all(cmds)):
        if rc:
            raise SystemExit(f"nvcc failed for {name}:\n{out[-3000:]}")
        mine = False   # ptxas's lines for this variant's own mode
        for ln in out.splitlines():
            if "Compiling entry" in ln:
                mine = name == "old" or (name in VARIANTS and
                                         f"trunk_{VARIANTS[name][0]}_" in ln)
            if mine and ("registers" in ln or "spill" in ln):
                print(f"  {name}: {ln.strip()}")
        for code in ("C7519", "C7520"):
            hits = [ln for ln in out.splitlines() if code in ln]
            if hits:
                print(f"  {name}: ptxas {code} x {len(hits)}: {hits[0][:300]}")
        libs[name] = ctypes.CDLL(cmd[-2])
    print(f"built {len(cmds)} variants in {time.time() - t0:.1f} s")
    return libs


def accumulation_flips(anime, x, dev) -> str:
    """Three of the trunk's convolutions on its own activations (conv0 on
    the first 4 tiles of x, convA on f, convB on l1, all bf16, mask 1),
    summed by the tensor cores (the conv-stage kernel's wgmma, f32 out) and
    by f32 FMAs (cuDNN, TF32 off): the share of outputs whose bf16 rounding
    differs from that of the float64 sums, and how many of those moved
    toward zero."""
    import torch.nn.functional as F

    from rusty_sr_tpu_torch.ops.activations import belu
    from rusty_sr_tpu_torch.ops.conv import exact_f32
    from rusty_sr_tpu_torch.ops.cuda import conv_stage

    pk = {k: v.to(dev) for k, v in trunk.pack_trunk_weights(anime, 3).items()}
    n = pk["f_bias"].shape[-1]
    inp = x[:4].to(torch.bfloat16)
    parts = []
    for name, k, then in (("w0", 5, "f"), ("wA", 5, "l1"), ("wB", 3, None)):
        w = pk[name].reshape(k, k, inp.shape[-1], -1).to(torch.bfloat16)
        tc = conv_stage.conv_stage(inp, conv_stage.prepare_stage(w))
        xt, wt = inp.permute(0, 3, 1, 2).double(), w.permute(3, 2, 0, 1)
        exact = F.conv2d(xt, wt.double(), padding=k // 2).permute(0, 2, 3, 1)
        with exact_f32():
            fma = F.conv2d(xt.float(), wt.float(), padding=k // 2)
        want = exact.float().to(torch.bfloat16)
        fma = fma.permute(0, 2, 3, 1)
        for label, y in (("tensor cores", tc), ("f32 FMA", fma)):
            got = y.to(torch.bfloat16)
            flip = got != want
            down = (got.float().abs() < want.float().abs()) & flip
            parts.append(f"{name} {label} {float(flip.double().mean()):.3g} "
                         f"({float(down.sum()) / max(1, int(flip.sum())):.0%} "
                         "toward zero)")
        if then:
            inp = belu(exact.float()[..., :n] + pk[then + "_bias"],
                       pk[then + "_belu"]).to(torch.bfloat16).contiguous()
    return ("bf16 roundings that differ from exact sums', the trunk's own "
            "activations: " + ", ".join(parts))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", default=os.path.join(_build.BUILD_DIR,
                                                  "trunk_old.cu"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trunk_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    libs = build(args.old if os.path.exists(args.old) else None)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    side = 256
    x = torch.from_numpy((rng.integers(0, 256, (24, side, side, 3))
                          / 255.0).astype(np.float32)).to(dev)
    m = torch.ones((24, side, side, 1), device=dev)
    s, e = side - 2 * trunk.HALO, 27
    out = torch.empty((24, s, s, e), device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    anime = params.load_builtin("anime")
    check = libs.pop("sqrt check")
    vec = trunk.pack_trunk_weights(anime, 3)
    slopes = torch.cat([vec[k].reshape(-1) for k in
                        ("f_belu", "l1_belu", "l2_belu", "l3_belu")]).to(dev)
    bad = torch.zeros(2, dtype=torch.int64, device=dev)
    check.run_sqrt_check.argtypes = [ptr, ptr, i32]
    t0 = time.time()
    if check.run_sqrt_check(bad.data_ptr(), slopes.data_ptr(),
                            slopes.numel()) != 0:
        raise SystemExit("sqrt check: launch failed")
    print(f"sqrt_ge1 vs sqrtf: {int(bad[0])} of {0x80000000 - 0x3f800000} "
          f"values y >= 1 differ; belu_bf16 vs belu: {int(bad[1])} of "
          f"{2 ** 32 * slopes.numel()} (x, slope) pairs differ "
          f"({time.time() - t0:.1f} s)")
    print(accumulation_flips(anime, x, dev))
    for mode, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        pk = {k: v.to(dev) for k, v in
              trunk.pack_trunk_weights(anime, 3, dtype).items()}
        want = trunk.fused_trunk_reference(pk, x, m, 3)
        exact = trunk.fused_trunk_reference(pk, x, m, 3, exact_sums=True)
        d = (want - exact).abs()
        print(f"{mode} plain: vs exact sums max {float(d.max()):.3g}, mean "
              f"{float(d.mean()):.3g}")
        vecs = [pk[k].data_ptr() for k in trunk._VECS]
        # "old" reads the five padded matrices in both modes.
        padded_t = [trunk._padded(pk[k]) for k in trunk._MATS]
        padded = [t.data_ptr() for t in padded_t]
        fns = {}
        for name, lib in libs.items():
            if name != "old" and VARIANTS[name][0] != mode:
                continue
            fn = getattr(lib, f"srt_trunk_{mode}")
            new_bf16 = mode == "bf16" and name != "old"
            mats = [pk["w_mma"].data_ptr()] if new_bf16 else padded
            fn.argtypes = [ptr] * (3 + len(mats) + 9) + [i32] * 5 + [ptr]
            fn.restype = i32
            args_ = [x.data_ptr(), m.data_ptr(), *mats, *vecs,
                     out.data_ptr(), 24, s, 3, 32, e, stream]
            fns[name] = (lambda f=fn, a=args_: f(*a))
        for name, fn in fns.items():
            out.fill_(float("nan"))
            if fn() != 0:
                raise SystemExit(f"{mode} {name}: launch failed")
            torch.cuda.synchronize()
            d = (out - want).abs()
            d2 = (out - exact).abs()
            digest = hashlib.sha1(out.cpu().numpy().tobytes()).hexdigest()
            print(f"{mode} {name}: vs plain max {float(d.max()):.3g}, mean "
                  f"{float(d.mean()):.3g}; vs exact sums max "
                  f"{float(d2.max()):.3g}, mean {float(d2.mean()):.3g}; "
                  f"output sha1 {digest[:12]}")
        times = {v: [] for v in fns}
        for v in list(fns) + list(fns)[::-1]:
            fns[v]()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                fns[v]()
            stop.record()
            torch.cuda.synchronize()
            times[v].append(start.elapsed_time(stop) / 5)
        print(f"{mode} trunk, 24 x 256^2: " + ", ".join(
            f"{v} {sum(t) / 2:.3f} ms" for v, t in times.items())
            + f" ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
