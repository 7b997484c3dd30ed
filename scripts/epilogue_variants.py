#!/usr/bin/env python3
"""The epilogue kernel's variants and its earlier version, built side by
side and timed in turns on the card at the main paths' shapes (24 tiles of
242^2, x3, the anime weights), each held against the plain version first.

    python3 scripts/epilogue_variants.py [--old PATH]     # from the repo root

Each variant is `rusty_sr_tpu_torch/csrc/shuffle.cu` compiled with the
port's nvcc flags after a text substitution of one block constant
(EP_SMEM, EP_ROWS, EP_THREADS), into ``rusty_sr_tpu_torch/_build/
variants_epi/``, and run through the port's wrappers with its entry points
swapped in.  ``--old`` adds an earlier `shuffle.cu` with the addend
interface (``srt_epilogue(x, addend, out, n, xh, xw, off, tile, c, f,
to_u8, stream)``, ``srt_depth_to_space_f32(x, addend, out, n, h, w, c, f,
stream)``); by default ``rusty_sr_tpu_torch/_build/shuffle_old.cu`` if it
exists, e.g. from ``git show <commit>:rusty_sr_tpu_torch/csrc/shuffle.cu``.

Prints each build's ptxas registers and spills; per form (the xla tiers'
u8 epilogue, the fused engine's f32 one, the packed one, the u8
depth-to-space) whether each variant is byte-identical to the plain
version, and its ms per call (CUDA events, 10 calls, in turns base, ...,
..., base); with the earlier kernel, its addend forms after the plain
casts and base against the new forms, and one 24-tile chunk of the xla
exact tier, the flat fast tier and the fused exact engine with each (the
outputs compared byte for byte); and the card's name and power limit.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import cuda_time_ms, synthetic_image  # noqa: E402
from rusty_sr_tpu_torch import params  # noqa: E402
from rusty_sr_tpu_torch.ops.cuda import _build, shuffle, trunk  # noqa: E402
from rusty_sr_tpu_torch.ops.resize import bilinear_phases_cropped  # noqa: E402
from rusty_sr_tpu_torch.parallel import tiling  # noqa: E402
from rusty_sr_tpu_torch.utils import native  # noqa: E402

CSRC = os.path.join(ROOT, "rusty_sr_tpu_torch", "csrc")
OUT = os.path.join(_build.BUILD_DIR, "variants_epi")
H = tiling.HALO

SMEM = "EP_SMEM = 72 * 1024;"
THREADS = "EP_THREADS = 256;"
# Block constants, and ablations that take one of the block's three passes
# out (their output is garbage; they only time what is left).
VARIANTS = {
    "base": [],
    "smem 24K": [(SMEM, "EP_SMEM = 24 * 1024;")],
    "smem 36K": [(SMEM, "EP_SMEM = 36 * 1024;")],
    "smem 100K": [(SMEM, "EP_SMEM = 100 * 1024;")],
    "rows 1": [("EP_ROWS = 2;", "EP_ROWS = 1;")],
    "threads 128": [(THREADS, "EP_THREADS = 128;")],
    "threads 128, smem 24K": [(THREADS, "EP_THREADS = 128;"),
                              (SMEM, "EP_SMEM = 24 * 1024;")],
    "threads 512": [(THREADS, "EP_THREADS = 512;")],
    "ablation: no staging copies": [
        ("    cp_async16(dst + k * V, base + k * V);", "    (void)base;")],
    "ablation: no pass 2": [("  const int units = nr * nc * C;",
                             "  const int units = 0;")],
    "ablation: no pass 3": [("  for (int i = tid; i < nr * f * chunks;",
                             "  for (int i = tid; i < 0;")],
}
_ENTRIES = ("srt_epilogue", "srt_depth_to_space")


class Swapped:
    """The port's library with the epilogue's entry points of another
    build."""

    def __init__(self, base, var):
        self.base, self.var = base, var

    def __getattr__(self, name):
        return getattr(self.var if name in _ENTRIES else self.base, name)


def build(old):
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(CSRC, "shuffle.cu")) as f:
        src = f.read()
    cmds, names = [], []
    for i, (name, subs) in enumerate(VARIANTS.items()):
        code = src
        for a, b in subs:
            if a not in code:
                raise SystemExit(f"variant {name} no longer matches: {a!r}")
            code = code.replace(a, b)
        path = os.path.join(OUT, f"v{i}.cu")
        with open(path, "w") as f:
            f.write(code)
        cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                     CSRC, "-o", os.path.join(OUT, f"v{i}.so"), path])
        names.append(name)
    if old:
        cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                     os.path.join(OUT, "old.so"), old])
        names.append("old")
    t0 = time.time()
    base = _build.load()
    libs = {}
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, (cmd, rc, out) in zip(names, _build._run_all(cmds)):
        if rc:
            raise SystemExit(f"nvcc failed for {name}:\n{out[-3000:]}")
        for ln in out.splitlines():
            if (name in ("base", "old") and "registers" in ln) or (
                    "spill" in ln and " 0 bytes spill" not in ln):
                print(f"  {name}: {ln.strip()}")
        lib = ctypes.CDLL(cmd[-2])
        if name == "old":
            lib.srt_epilogue.argtypes = [ptr] * 3 + [i32] * 8 + [ptr]
            lib.srt_depth_to_space_f32.argtypes = [ptr] * 3 + [i32] * 5 + [ptr]
            libs[name] = lib
        else:
            lib.srt_epilogue.argtypes = [ptr, ptr, i32, ptr] + [i32] * 12 + [ptr]
            lib.srt_depth_to_space.argtypes = [ptr] * 2 + [i32] * 6 + [ptr]
            libs[name] = Swapped(base, lib)
    print(f"built {len(cmds)} variants in {time.time() - t0:.1f} s")
    return base, libs


def turns(fns: dict) -> dict:
    """ms per call of each function, timed in turns (each twice, in order
    and in reverse) after two warm-up calls of each."""
    for fn in fns.values():
        fn()
        fn()
    times = {k: [] for k in fns}
    order = list(fns) + list(fns)[::-1]
    for k in order:
        times[k].append(cuda_time_ms(fns[k]))
    return {k: sum(v) / len(v) for k, v in times.items()}


def same_bytes(a, b):
    return (a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))


def main() -> int:
    ap = argparse.ArgumentParser()
    default_old = os.path.join(_build.BUILD_DIR, "shuffle_old.cu")
    ap.add_argument("--old", default=default_old if os.path.exists(
        default_old) else None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("epilogue_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    dev = torch.device("cuda")
    base, libs = build(args.old)
    old = libs.pop("old", None)

    anime = params.load_builtin("anime")
    lr = synthetic_image(np.random.default_rng(0), 768, 1024)
    img = lr.astype(np.float32) / 255.0
    gen = torch.Generator(device="cpu").manual_seed(0)

    def pad24(ts):
        return [torch.from_numpy(np.pad(t, ((0, 24 - t.shape[0]),)
                                        + ((0, 0),) * 3)).to(dev) for t in ts]

    nx = -(-lr.shape[1] // 242)
    xl = pad24(native.gather_tiles_range(lr, 242, H, nx, 0, 20))
    fl = pad24(native.gather_tiles_range(lr, 241, H, -(-lr.shape[1] // 241),
                                         0, 20))
    fz, fe, fm = pad24(native.gather_tiles_range(img, 242, H, nx, 0, 20))
    packed3 = {k: v.to(dev) for k, v in trunk.pack_trunk_weights(
        tiling.trunk_params(anime), 3, torch.float32).items()}
    expand = trunk.fused_trunk(packed3, fz, fm, 3)
    epi_x = (torch.randn((24, 256, 256, 27), generator=gen) * 0.4
             + 0.5).to(dev)
    packed_x = tiling._pack_s2d(epi_x).contiguous()
    d2s_x = torch.randint(0, 256, (24, 240, 240, 27), generator=gen,
                          dtype=torch.uint8).to(dev)
    forms = {   # name -> (wrapper call, plain call)
        "xla u8": (lambda: shuffle.epilogue_cuda(epi_x, 3, 242, H, xl[1],
                                                 to_u8=True),
                   lambda: shuffle.epilogue_reference(epi_x, 3, 242, H, xl[1],
                                                      to_u8=True)),
        "fused f32": (lambda: shuffle.epilogue_cuda(expand, 3, 242, 0, fe),
                      lambda: shuffle.epilogue_reference(expand, 3, 242, 0,
                                                         fe)),
        "packed u8": (lambda: shuffle.epilogue_cuda(
            packed_x, 3, 242, H, to_u8=True, packed=True),
            lambda: shuffle.epilogue_reference(
                packed_x, 3, 242, H, to_u8=True, packed=True)),
        "d2s u8": (lambda: shuffle.depth_to_space_cuda(d2s_x, 3),
                   lambda: shuffle.depth_to_space_reference(d2s_x, 3))}

    def on(lib, fn):
        def run():
            _build._lib = lib
            return fn()
        return run

    for form, (kernel, plain) in forms.items():
        want = plain()
        checks = {name: same_bytes(on(lib, kernel)(), want)
                  for name, lib in libs.items()}
        ms = turns({name: on(lib, kernel) for name, lib in libs.items()})
        print(f"{form}: " + ", ".join(
            f"{name} {ms[name]:.4f} ms"
            f"{'' if checks[name] else ' (DIFFERENT from plain)'}"
            for name in libs) + f" (CUDA events; {card})")
    _build._lib = base
    if old is None:
        print("no earlier shuffle.cu: pass --old or put one at "
              f"{default_old}")
        return 0

    stream = lambda: ctypes.c_void_p(  # noqa: E731
        torch.cuda.current_stream().cuda_stream)

    def old_epilogue(x, tile, off, addend, to_u8):
        n, xh, xw, ch = x.shape
        out = torch.empty((n, 3 * tile, 3 * tile, 3), device=dev,
                          dtype=torch.uint8 if to_u8 else torch.float32)
        assert old.srt_epilogue(x.data_ptr(), addend.data_ptr(),
                                out.data_ptr(), n, xh, xw, off, tile, 3, 3,
                                int(to_u8), stream()) == 0
        return out

    def old_d2s(x, addend):
        n, hh, ww, _ = x.shape
        out = torch.empty((n, 3 * hh, 3 * ww, 3), device=dev)
        assert old.srt_depth_to_space_f32(x.data_ptr(), addend.data_ptr(),
                                          out.data_ptr(), n, hh, ww, 3, 3,
                                          stream()) == 0
        return out

    # The earlier kernel's addend forms (base precomputed) against the new
    # forms, which compute it.
    base_u8 = bilinear_phases_cropped(xl[1].float() * (1.0 / 255.0), 3, H, H,
                                      242)
    base_f = bilinear_phases_cropped(fe, 3, H, H, 242)
    pairs = {
        "xla u8": (lambda: old_epilogue(epi_x, 242, H, base_u8, True),
                   forms["xla u8"][0]),
        "fused f32": (lambda: old_d2s(expand, base_f), forms["fused f32"][0])}
    for form, (o, n) in pairs.items():
        same = same_bytes(o(), n())
        ms = turns({"earlier (addend)": o, "new (edge tiles)": n})
        print(f"{form} kernel alone: earlier kernel + precomputed base "
              f"{ms['earlier (addend)']:.4f} ms, new kernel "
              f"{ms['new (edge tiles)']:.4f} ms "
              f"({'byte-identical' if same else 'DIFFERENT'}; {card})")

    # One 24-tile chunk as the earlier tile kernels ran it (the plain casts
    # and base, then the addend form), and as the tile kernels run it now.
    fp = tiling.prepare_stages({k: v.to(dev) for k, v in tiling
                                .flat_trunk_params(anime, True).items()})
    fx = tiling.prepare_stages({k: v.to(dev) for k, v in tiling
                                .flat_trunk_params(anime, False).items()})

    def earlier_flat(z8, e8, m8, fast, tile):
        zero = z8.float() * (1.0 / 255.0)
        edge = e8.float() * (1.0 / 255.0)
        mask = m8.float()
        ex = (tiling._flat_fast_trunk(fp, zero, z8, mask) if fast
              else tiling._flat_exact_trunk(fx, zero, mask))
        base_ph = bilinear_phases_cropped(edge, 3, H, H, tile)
        return old_epilogue(ex.contiguous(), tile, H, base_ph, True)

    def earlier_fused():
        ex = trunk.fused_trunk(packed3, fz, fm, 3)
        return old_d2s(ex, bilinear_phases_cropped(fe, 3, H, H, 242))

    chunks = {
        "xla exact": (lambda: earlier_flat(*xl, False, 242),
                      lambda: tiling._tile_kernel(fx, *xl, 3, 242, False,
                                                  True)),
        "flat fast": (lambda: earlier_flat(*fl, True, 241),
                      lambda: tiling._tile_kernel(fp, *fl, 3, 241, True,
                                                  True)),
        "fused exact": (earlier_fused,
                        lambda: tiling._tile_kernel_fused(
                            packed3, fz, fe, fm, 3, 242, torch.float32))}
    for tier, (o, n) in chunks.items():
        same = same_bytes(o(), n())
        ms = turns({"earlier": o, "now": n})
        print(f"{tier} chunk, 24 tiles: earlier (plain casts and base + "
              f"addend kernel) {ms['earlier']:.3f} ms, now (base in the "
              f"epilogue kernel) {ms['now']:.3f} ms, "
              f"{ms['earlier'] - ms['now']:.3f} ms saved "
              f"({'byte-identical' if same else 'DIFFERENT'}; CUDA events, "
              f"2 x 10 calls each; {card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
