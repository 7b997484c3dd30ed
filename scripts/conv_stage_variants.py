#!/usr/bin/env python3
"""Where the conv-stage kernel's time goes: variants of
`rusty_sr_tpu_torch/csrc/conv_stage.cu`, each with one piece taken out
or one setting changed, built side by side and timed in turns on the
card at the fast tiers' stage shapes (24 tiles, anime weights).

    python3 scripts/conv_stage_variants.py     # from the repository root

Each variant is the kernel's source with a text substitution, compiled
with the port's nvcc flags into ``rusty_sr_tpu_torch/_build/variants/``.
The variants that drop work compute nothing useful; they only time what
is left.  Prints one line per stage shape: ms per call of each variant
(CUDA events, 10 calls, in turns base, ..., ..., base), with the card's
name and power limit.
"""

import ctypes
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from rusty_sr_tpu_torch import params  # noqa: E402
from rusty_sr_tpu_torch.ops.cuda import _build  # noqa: E402
from rusty_sr_tpu_torch.ops.cuda import conv_stage as cs  # noqa: E402
from rusty_sr_tpu_torch.parallel import tiling  # noqa: E402

CSRC = os.path.join(ROOT, "rusty_sr_tpu_torch", "csrc")
OUT = os.path.join(_build.BUILD_DIR, "variants")

PRODUCER_COPY = """      mbar_expect_tx(&full[slot], bytes);
      bulk_copy(ring + (size_t)slot * pl.slot,
                wb + (size_t)CS_STEPS * q * 16 * NI, bytes, &full[slot]);"""
WINDOW_COPY = """      mbar_expect_tx(&winbar[j], (uint32_t)box_planes * pl.plane);
      tma_load_window(win + (size_t)j * 4 * pl.plane, &map, &winbar[j], 0,
                      x0 - r, y - r, 4 * j, img);"""
EPILOGUE = "  consumer_sync();\n  constexpr int SP"


def sub(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"variant no longer matches the source: {old!r}")
    return src.replace(old, new)


def variants(src: str) -> dict:
    """name -> source.  Every variant keeps every barrier arrival, so none
    can wait forever."""
    no_mma = sub(src, "      wgmma_bf16<NI>(acc, make_desc(a0",
                 "      if (cout < 0) wgmma_bf16<NI>(acc, make_desc(a0")
    no_weights = "      (void)bytes;\n      mbar_arrive(&full[slot]);"
    no_window = "      mbar_arrive(&winbar[j]);"
    no_epilogue = "  if (cout > 0) return;\n" + EPILOGUE
    skeleton = sub(sub(sub(no_mma, PRODUCER_COPY, no_weights), WINDOW_COPY,
                       no_window), EPILOGUE, no_epilogue)
    steps = "constexpr int CS_STEPS = 8;"
    slots = "constexpr int CS_MAX_SLOTS = 2;"
    return {
        "base": src,
        "divergent_role": sub(src, "__shfl_sync(0xffffffffu, tid / 32, 0)",
                              "tid / 32"),
        "steps4_slots4": sub(sub(src, steps, "constexpr int CS_STEPS = 4;"),
                             slots, "constexpr int CS_MAX_SLOTS = 4;"),
        "steps2_slots4": sub(sub(src, steps, "constexpr int CS_STEPS = 2;"),
                             slots, "constexpr int CS_MAX_SLOTS = 4;"),
        "no_mma": no_mma,
        "no_weights": sub(src, PRODUCER_COPY, no_weights),
        "no_window": sub(src, WINDOW_COPY, no_window),
        "no_epilogue": sub(src, EPILOGUE, no_epilogue),
        "skeleton": skeleton,
    }


def build(vs: dict) -> dict:
    os.makedirs(OUT, exist_ok=True)
    cmds = []
    for name, code in vs.items():
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as f:
            f.write(code)
        cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                     CSRC, "-o", os.path.join(OUT, f"{name}.so"), path])
    t0 = time.time()
    for cmd, rc, out in _build._run_all(cmds):
        serial = [ln for ln in out.splitlines() if "C7520" in ln]
        if serial:
            print(f"{os.path.basename(cmd[-1])}: ptxas C7520 (wgmma "
                  f"serialised) in {len(serial)} instantiations")
        if rc:
            raise SystemExit(f"nvcc failed for {cmd[-1]}:\n{out[-3000:]}")
    print(f"built {len(vs)} variants in {time.time() - t0:.1f} s")
    libs = {}
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in vs:
        lib = ctypes.CDLL(os.path.join(OUT, f"{name}.so"))
        lib.srt_conv_stage.argtypes = (
            [ptr, i64, ptr, ptr, i64] + [i32] * 12
            + [ptr, ptr, ptr, i64, ptr, i64, ptr, i32, ptr])
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("conv_stage_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    with open(os.path.join(CSRC, "conv_stage.cu")) as f:
        libs = build(variants(f.read()))
    dev = torch.device("cuda")
    anime = params.load_builtin("anime")
    pp = tiling.packed_trunk_params(anime, 3)
    fp = tiling.flat_trunk_params(anime, True)
    gen = torch.Generator().manual_seed(0)
    cases = [("packed WA", (24, 128, 128, 128), pp["WA"]),
             ("packed WD", (24, 128, 128, 152), pp["WD"]),
             ("flat convA", (24, 255, 255, 32), fp["convA_bf16"]),
             ("flat convC", (24, 255, 255, 32), fp["convC_bf16"])]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for name, shape, w in cases:
        x = torch.randn(shape, generator=gen).to(torch.bfloat16).to(dev)
        sw = cs.prepare_stage(w.to(dev))
        cout = w.shape[3]
        out = torch.empty(shape[:3] + (cout,), device=dev,
                          dtype=torch.bfloat16)

        def call(lib):
            return lambda: lib.srt_conv_stage(
                x.data_ptr(), shape[3], sw.image.data_ptr(), out.data_ptr(),
                cout, shape[0], shape[1], shape[2], shape[3], cout,
                w.shape[0], sw.ni, 1, 0, 0, 0, 0, None, None, None, 0, None,
                0, None, 0, stream)
        fns = {v: call(lib) for v, lib in libs.items()}
        for v, fn in fns.items():
            if fn() != 0 or fn() != 0:
                raise SystemExit(f"variant {v} failed to launch")
        torch.cuda.synchronize()
        times = {v: [] for v in fns}
        for v in list(fns) + list(fns)[::-1]:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                fns[v]()
            stop.record()
            torch.cuda.synchronize()
            times[v].append(start.elapsed_time(stop) / 10)
        print(f"{name}, {shape} -> {cout}: " + ", ".join(
            f"{v} {sum(t) / 2:.3f} ms" for v, t in times.items())
            + f" ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
