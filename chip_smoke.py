#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`rusty_sr_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of the repository

Phases, each fatal on failure:

1. print the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions and the PNG codec in use;
2. build the kernels from ``rusty_sr_tpu_torch/csrc`` with nvcc;
3. hold each kernel against its plain PyTorch version on the card, at
   the shapes the main paths give it (anime weights, factor 3, a chunk of
   24 tiles of 256^2 padded) plus ragged odd tiles and factor 2: the
   trunk in f32 (atol 1e-5) and in bf16 (max 1e-2, mean 1e-4); the
   depth-to-space kernel (byte-identical) in f32 with the addend and in
   u8; the conv-stage kernel at the packed fast tier's five stages (24
   tiles of 128^2 packed), the flat fast tier's six convs (24 x 256^2)
   and the shapes of the TPU conv-stage probes (f32 out within 1e-5 of
   the largest plain output; bf16 out within that plus 1 bf16 ulp, with
   at most 1e-3 of the values differing); the epilogue (byte-identical) in u8
   and in f32 with the halo crop and the base, and in the packed form;
4. run the CLI end to end on a synthetic 1024x768 PNG, each path with
   the launch counts set to 0 just before it and read just after:
   ``--engine fused -p anime`` (the f32 trunk and the shuffle ran; within
   1 u8 code of the same run through the plain versions), ``--engine
   fused --fast`` (the bf16 trunk and the shuffle ran; within 4 codes of
   the plain run, and at least 45 dB and at most 8 codes against the
   exact tier); the default engine, xla, exact (the epilogue ran; within
   1 code of the plain run and of the fused engine), ``--fast`` (the
   packed tier: the conv stage and the epilogue ran; within 4 codes of
   the plain run, at least 45 dB and at most 8 codes against exact) and
   ``--fast --tile 241`` (an odd padded side: the flat fast tier, the
   same bounds); ``-p bilinear`` (the shuffle ran) and ``-d`` (each
   byte-identical to the run through the plain versions, and within 1
   code of the CPU); then check that both engines' tiled paths agree
   with the whole-image network on a small crop;
5. time each kernel and its plain version with CUDA events, in turns
   (the conv stage at the packed stages and at each probe's shape), and
   the CLI runs on the host clock.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists each kernel with its launches (summed over the CLI paths above),
error and times.  Without a CUDA device, or outside the repository, it
exits non-zero and prints no result.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

TOL = 1e-5   # f32: kernel and plain version sum K <= 800 products in other orders
# bf16: a sum in another order can flip a bf16 rounding, and the later
# stages carry that ulp (tests/test_torch_trunk.py)
BF16_MAX, BF16_MEAN = 1e-2, 1e-4
# The conv stage: f32 out within CONV_REL of the largest plain output
# (exact bf16 products, f32 sums in another order); bf16 out within that
# bound plus one bf16 ulp (a crossed rounding midpoint), with at most
# CONV_SHARE of the values differing.
CONV_REL, CONV_SHARE = 1e-5, 1e-3
SEED = 0


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def synthetic_image(rng, h: int, w: int) -> np.ndarray:
    """Smooth gradients, edges and noise, as u8 (H, W, 3)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([xx / w, yy / h, 0.5 + 0.5 * np.sin(xx / 17.0 + yy / 23.0)],
                    axis=-1)
    base += ((xx // 64 + yy // 48) % 2)[..., None] * 0.25
    base += rng.normal(0.0, 0.05, base.shape)
    return (np.clip(base, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def cuda_time_ms(fn, iters: int = 10) -> float:
    import torch
    start, stop = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def time_in_turns(plain, kernel):
    """Mean ms per call of each, timed plain, kernel, kernel, plain after
    two warm-up calls of each."""
    for fn in (plain, kernel):
        fn()
        fn()
    times = {plain: [], kernel: []}
    for fn in (plain, kernel, kernel, plain):
        times[fn].append(cuda_time_ms(fn))
    return sum(times[kernel]) / 2, sum(times[plain]) / 2


def bf16_excess_ulps(got, want, f32_bound):
    """|got - want| beyond ``f32_bound``, in bf16 ulps at the larger
    magnitude."""
    import torch
    got, want = got.float(), want.float()
    m = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -126)
    excess = ((got - want).abs() - f32_bound).clamp_min(0.0)
    return excess / torch.exp2(torch.floor(torch.log2(m)) - 7)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rusty_sr_tpu_torch import cli, params
    from rusty_sr_tpu_torch.api import upscale
    from rusty_sr_tpu_torch.models.sr_net import sr_apply
    from rusty_sr_tpu_torch.ops.cuda import _build, conv_stage, shuffle, trunk
    from rusty_sr_tpu_torch.ops.resize import bilinear_phases_cropped
    from rusty_sr_tpu_torch.parallel import tiling
    from rusty_sr_tpu_torch.utils import imageio, native

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    bf = torch.bfloat16

    # 1. The card and the software.
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, PNG codec {imageio.codec()}")

    # 2. Build.
    t0 = time.time()
    lib = _build.load()
    print(f"built {os.path.relpath(_build.library_path())} in "
          f"{time.time() - t0:.1f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())
    del lib

    # 3. Each kernel against its plain version, at the main path's shapes.
    anime = params.load_builtin("anime")
    lr = synthetic_image(rng, 768, 1024)
    img = lr.astype(np.float32) / 255.0

    def chunk_of(image, tile, count):
        ny = -(-image.shape[0] // tile)
        nx = -(-image.shape[1] // tile)
        tiles = native.gather_tiles_range(image, tile, tiling.HALO, nx, 0,
                                          min(count, ny * nx))
        pad = ((0, count - tiles[0].shape[0]), (0, 0), (0, 0), (0, 0))
        return [torch.from_numpy(np.pad(t, pad)).to(dev) for t in tiles]

    def packs(tree, f, dtype):
        return {k: v.to(dev) for k, v in trunk.pack_trunk_weights(
            tiling.trunk_params(tree), f, dtype).items()}

    main_x, main_e, main_m = chunk_of(img, 242, 24)   # (24, 256, 256, 3)
    cases = [("anime f=3, 24 x 256^2", anime, main_x, main_m, 3),
             ("anime f=3, ragged 37", anime,
              *chunk_of(img[:100, :130], 37, 12)[::2], 3),
             ("init f=2, ragged 61", params.init_params(7, 2),
              *chunk_of(img[:150, :200], 61, 6)[::2], 2)]
    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        mode = "f32" if dtype == torch.float32 else "bf16"
        for name, tree, x, m, f in cases:
            pk = packs(tree, f, dtype)
            got = trunk.fused_trunk(pk, x, m, f)
            want = trunk.fused_trunk_reference(pk, x, m, f)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                fail(f"{mode} trunk kernel, {name}: non-finite output")
            diff = (got - want).abs()
            err, mean = float(diff.max()), float(diff.mean())
            if dtype == torch.float32:
                print(f"f32 trunk kernel vs plain, {name}: max abs err "
                      f"{err:.3g} (tol {TOL})")
                ok = err <= TOL
            else:
                print(f"bf16 trunk kernel vs plain, {name}: max abs err "
                      f"{err:.3g}, mean {mean:.3g} (tol {BF16_MAX}, "
                      f"{BF16_MEAN})")
                ok = err <= BF16_MAX and mean <= BF16_MEAN
            if not ok:
                fail(f"{mode} trunk kernel, {name}: max abs err {err}, mean "
                     f"{mean}")
            max_err[dtype] = max(max_err[dtype], err)

    packed3 = packs(anime, 3, torch.float32)
    packed3_bf16 = packs(anime, 3, torch.bfloat16)
    main_expand = trunk.fused_trunk(packed3, main_x, main_m, 3)
    main_base = bilinear_phases_cropped(main_e, 3, tiling.HALO, tiling.HALO,
                                        242)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    d2s_cases = [
        ("f32 + addend, (24, 242, 242, 27)", main_expand, main_base, 3),
        ("u8, (24, 240, 240, 27)",
         torch.randint(0, 256, (24, 240, 240, 27), generator=gen,
                       dtype=torch.uint8).to(dev), None, 3),
        ("f32 + addend, f=2 ragged (6, 61, 47, 12)",
         torch.randn((6, 61, 47, 12), generator=gen).to(dev),
         torch.randn((6, 61, 47, 12), generator=gen).to(dev), 2)]
    d2s_err = 0.0
    for name, x, add, f in d2s_cases:
        got = shuffle.depth_to_space_cuda(x, f, addend=add)
        want = shuffle.depth_to_space_reference(x, f, add)
        torch.cuda.synchronize()
        same = (got.shape == want.shape and got.dtype == want.dtype
                and bool((got.view(torch.uint8) == want.view(torch.uint8))
                         .all()))
        if same:
            d2s_err = max(d2s_err, float((got.float() - want.float()).abs()
                                         .max()))
        print(f"depth-to-space kernel vs plain, {name}: "
              f"{'byte-identical' if same else 'DIFFERENT'}")
        if not same:
            fail(f"depth-to-space kernel, {name}: not byte-identical")

    # The conv-stage kernel: the packed tier's stages with their weights,
    # the flat tier's convs with theirs, and each TPU probe's own shape.
    pp = {k: v.to(dev) for k, v in
          tiling.packed_trunk_params(anime, 3).items()}
    fp = {k: v.to(dev) for k, v in
          tiling.flat_trunk_params(anime, fast=True).items()}

    def act(shape, u8=False):
        """bf16 activations: u8 codes / 256 (the conv0 inputs) or
        normal values."""
        if u8:
            t = torch.randint(0, 256, shape, generator=gen).float() / 256.0
        else:
            t = torch.randn(shape, generator=gen)
        return t.to(bf).to(dev)

    def probe_w(k, cin, cout):
        return (torch.randn((k, k, cin, cout), generator=gen)
                / (k * k * cin) ** 0.5).to(bf).to(dev)

    p128, p256 = (24, 128, 128), (24, 256, 256)
    f32 = torch.float32
    conv_cases = [   # name, x, w, out dtype, timed as
        ("packed W0", act(p128 + (24,), u8=True), pp["W0"], f32, "packed"),
        ("packed WA", act(p128 + (128,)), pp["WA"], bf, "packed"),
        ("packed WB", act(p128 + (128,)), pp["WB"], bf, "packed"),
        ("packed WC", act(p128 + (128,)), pp["WC"], bf, "packed"),
        ("packed WD", act(p128 + (152,)), pp["WD"], f32, "packed"),
        ("flat conv0 (u8 split)", act(p256 + (6,), u8=True), fp["conv0_u8"],
         f32, None),
        ("flat conv0 (f32 split)", act(p256 + (9,)), fp["conv0_f32"], f32,
         None),
        ("flat convA", act(p256 + (32,)), fp["convA_bf16"], bf, None),
        ("flat convB", act(p256 + (32,)), fp["convB_bf16"], bf, None),
        ("flat convC", act(p256 + (32,)), fp["convC_bf16"], bf, None),
        ("flat conv10", act(p256 + (32,)), fp["conv10_bf16"], bf, None),
        ("row 3, mosaic_probe.py: 24x136 px, 1x1, 32->96",
         act((1, 24, 136, 32)), probe_w(1, 32, 96), f32, "row 3"),
        ("row 4, mosaic_probe2.py: 16x128 px, 3x3, 32->96",
         act((1, 16, 128, 32)), probe_w(3, 32, 96), f32, "row 4"),
        ("row 5, mosaic_probe3.py: 128 x 16x128 px, 5x5, 32->96",
         act((128, 16, 128, 32)), probe_w(5, 32, 96), f32, "row 5"),
        ("row 6, mosaic_probe4.py: 64 x 16x256 px, 5x5, 32->96",
         act((64, 16, 256, 32)), probe_w(5, 32, 96), f32, "row 6"),
        ("row 7, mosaic_probe5.py: 64 x 16x256 px, 3x3, 32->96",
         act((64, 16, 256, 32)), probe_w(3, 32, 96), f32, "row 7")]
    conv_err = 0.0
    for name, x, w, odt, _ in conv_cases:
        got = conv_stage.conv_stage(x, w, odt)
        want = conv_stage.conv_stage_reference(x, w, odt)
        torch.cuda.synchronize()
        if got.dtype != odt or got.shape != want.shape:
            fail(f"conv stage, {name}: {got.dtype} {tuple(got.shape)}")
        if not torch.isfinite(got.float()).all():
            fail(f"conv stage, {name}: non-finite output")
        err = float((got.float() - want.float()).abs().max())
        conv_err = max(conv_err, err)
        scale = float(want.float().abs().max())
        if odt == f32:
            print(f"conv stage vs plain, {name}, f32 out: max abs err "
                  f"{err:.3g} = {err / scale:.3g} of max|plain| (tol "
                  f"{CONV_REL})")
            ok = err <= CONV_REL * scale
        else:
            u = bf16_excess_ulps(got, want, CONV_REL * scale)
            share = float((got != want).float().mean())
            print(f"conv stage vs plain, {name}, bf16 out: max abs err "
                  f"{err:.3g}, {float(u.max()):.3g} ulp beyond "
                  f"{CONV_REL} of max|plain|, {share:.3g} of values differ "
                  f"(tol 1 ulp, {CONV_SHARE})")
            ok = float(u.max()) <= 1 and share <= CONV_SHARE
        if not ok:
            fail(f"conv stage, {name}: outside its bound")
    del got, want

    # The epilogue: the exact tier's u8 and f32 forms (crop + base), the
    # packed tier's quantise-unpack form, and a ragged factor-2 case.
    h = tiling.HALO

    def near_unit(shape):
        return (torch.randn(shape, generator=gen) * 0.4 + 0.5).to(dev)

    epi_x = near_unit((24, 256, 256, 27))
    epi_add = (torch.randn((24, 242, 242, 27), generator=gen) * 0.1).to(dev)
    epi_packed = near_unit((24, 128, 128, 108))
    epi_cases = [
        ("u8, crop 7 + base, (24, 256, 256, 27) -> 726^2", epi_x, 3, 242,
         dict(addend=epi_add, to_u8=True)),
        ("f32, crop 7 + base, (24, 256, 256, 27) -> 726^2", epi_x, 3, 242,
         dict(addend=epi_add)),
        ("packed u8, (24, 128, 128, 108) -> 726^2", epi_packed, 3, 242,
         dict(to_u8=True, packed=True)),
        ("u8 f=2 ragged, (6, 75, 75, 12) -> 122^2", near_unit((6, 75, 75, 12)),
         2, 61, dict(addend=(torch.randn((6, 61, 61, 12), generator=gen)
                             * 0.1).to(dev), to_u8=True))]
    epi_err = 0.0
    for name, x, f, tile, kw in epi_cases:
        got = shuffle.epilogue_cuda(x, f, tile, h, **kw)
        want = shuffle.epilogue_reference(x, f, tile, h, **kw)
        torch.cuda.synchronize()
        same = (got.shape == want.shape and got.dtype == want.dtype
                and torch.equal(got.view(torch.uint8), want.view(torch.uint8)))
        if same:
            epi_err = max(epi_err, float((got.float() - want.float()).abs()
                                         .max()))
        print(f"epilogue kernel vs plain, {name}: "
              f"{'byte-identical' if same else 'DIFFERENT'}")
        if not same:
            fail(f"epilogue kernel, {name}: not byte-identical")

    # 4. The main paths: the CLI, end to end.
    def zero_counts():
        torch.cuda.synchronize()
        for k in trunk.LAUNCHES:
            trunk.LAUNCHES[k] = 0
        shuffle.LAUNCHES = 0
        shuffle.EPILOGUE_LAUNCHES = 0
        conv_stage.LAUNCHES = 0

    def counts():
        torch.cuda.synchronize()
        return {"f32": trunk.LAUNCHES[torch.float32],
                "bf16": trunk.LAUNCHES[torch.bfloat16],
                "d2s": shuffle.LAUNCHES, "epi": shuffle.EPILOGUE_LAUNCHES,
                "conv": conv_stage.LAUNCHES}

    def run_cli(argv, what):
        rc = cli.main(argv)
        if rc != 0:
            fail(f"CLI {what} exited {rc}")

    swaps = (("fused_trunk", trunk.fused_trunk_reference),
             ("depth_to_space_cuda", shuffle.depth_to_space_reference),
             ("conv_stage", conv_stage.conv_stage_reference),
             ("epilogue_cuda", shuffle.epilogue_reference))

    def run_plain(argv, what):
        """The CLI with every kernel swapped for its plain version."""
        saved = [(name, getattr(tiling, name)) for name, _ in swaps]
        for name, plain in swaps:
            setattr(tiling, name, plain)
        try:
            run_cli(argv, what + " through the plain versions")
        finally:
            for name, fn in saved:
                setattr(tiling, name, fn)

    def u8(path):
        return imageio.load_image_u8(path).astype(np.int16)

    def differ(a, b):
        return int(np.abs(a - b).max()), int((a != b).sum())

    hr_mpix = lr.shape[0] * 3 * lr.shape[1] * 3 / 1e6
    launches = {"f32": 0, "bf16": 0, "d2s": 0, "epi": 0, "conv": 0}
    walls = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        def out(name):
            return os.path.join(tmp, name)

        src = out("lr.png")
        imageio.save_image_u8(src, lr)
        # (tier, flags, kernels that must launch, bound vs the plain run)
        runs = (("fused exact", ["--engine", "fused"], ("f32", "d2s"), 1),
                ("fused fast", ["--engine", "fused", "--fast"],
                 ("bf16", "d2s"), 4),
                ("xla exact", [], ("epi",), 1),
                ("xla fast", ["--fast"], ("conv", "epi"), 4),
                ("xla fast flat", ["--fast", "--tile", "241"],
                 ("conv", "epi"), 4))
        for tier, flags, must, bound in runs:
            argv = ["-p", "anime", *flags, src]
            name = tier.replace(" ", "_")
            zero_counts()
            t0 = time.time()
            run_cli(argv + [out(f"{name}_kernel.png")], tier)
            n = counts()
            walls[tier] = wall = time.time() - t0
            print(f"CLI {tier}: {lr.shape[1]}x{lr.shape[0]} -> "
                  f"{lr.shape[1] * 3}x{lr.shape[0] * 3} in {wall:.3f} s wall "
                  f"= {hr_mpix / wall:.2f} HR MPix/s (launches: f32 trunk "
                  f"{n['f32']}, bf16 trunk {n['bf16']}, depth-to-space "
                  f"{n['d2s']}, epilogue {n['epi']}, conv stage "
                  f"{n['conv']}; {card})")
            for k in must:
                if n[k] < 1:
                    fail(f"the CLI {tier} run launched no {k} kernel")
            for k in launches:
                launches[k] += n[k]
            run_plain(argv + [out(f"{name}_plain.png")], tier)
            hk, hp = u8(out(f"{name}_kernel.png")), u8(out(f"{name}_plain.png"))
            if hk.shape != (lr.shape[0] * 3, lr.shape[1] * 3, 3):
                fail(f"CLI {tier} output has shape {hk.shape}")
            worst, count = differ(hk, hp)
            print(f"CLI {tier} PNG, kernels vs plain: max {worst} u8 codes "
                  f"({count} values differ; bound {bound})")
            if worst > bound:
                fail(f"CLI {tier} output differs by {worst} u8 codes from "
                     "the plain run")
        he = u8(out("xla_exact_kernel.png"))
        worst, count = differ(he, u8(out("fused_exact_kernel.png")))
        print(f"CLI xla exact vs fused exact: max {worst} u8 codes ({count} "
              "values differ; bound 1)")
        if worst > 1:
            fail(f"xla exact vs fused exact: {worst} codes")
        for fast, exact in (("fused_fast", "fused_exact"),
                            ("xla_fast", "xla_exact"),
                            ("xla_fast_flat", "xla_exact")):
            hf, hx = u8(out(f"{fast}_kernel.png")), u8(out(f"{exact}_kernel.png"))
            db = imageio.psnr(hf / 255.0, hx / 255.0)
            worst, count = differ(hf, hx)
            print(f"CLI {fast} vs {exact}: {db:.2f} dB, max {worst} u8 codes "
                  f"({count} values differ; bounds 45 dB, 8)")
            if not (db >= 45.0 and worst <= 8):
                fail(f"{fast} vs {exact}: {db:.2f} dB, {worst} codes")

        for mode, flags in (("bilinear", ["-p", "bilinear"]),
                            ("downsample", ["-d"])):
            zero_counts()
            run_cli([*flags, src, out(f"{mode}_kernel.png")], mode)
            n = counts()
            print(f"CLI {mode}: launches: depth-to-space {n['d2s']}")
            if mode == "bilinear" and n["d2s"] < 1:
                fail("the bilinear CLI run launched no depth-to-space kernel")
            for k in launches:
                launches[k] += n[k]
            run_plain([*flags, src, out(f"{mode}_plain.png")], mode)
            run_cli(["--platform", "cpu", *flags, src,
                     out(f"{mode}_cpu.png")], mode + " on the CPU")
            hk = u8(out(f"{mode}_kernel.png"))
            same = hk.tobytes() == u8(out(f"{mode}_plain.png")).tobytes()
            worst, count = differ(hk, u8(out(f"{mode}_cpu.png")))
            print(f"CLI {mode} PNG {hk.shape}: "
                  f"{'byte-identical to' if same else 'DIFFERENT from'} the "
                  f"plain run; vs the CPU max {worst} u8 codes ({count} "
                  f"values differ)")
            if not same or worst > 1 or count >= 1e-3 * hk.size:
                fail(f"CLI {mode} output disagrees with its plain or CPU run")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    crop = img[:90, :130]
    whole = sr_apply(params.to_torch(anime, dev),
                     torch.from_numpy(crop)[None].to(dev), 3)[0].cpu().numpy()
    for engine in ("fused", "xla"):
        tiled = upscale(crop, anime, 3, engine=engine, tile=45, chunk=4,
                        device=dev)
        err_whole = float(np.abs(tiled - whole).max())
        print(f"tiled {engine} path vs whole-image network, 90x130: max abs "
              f"err {err_whole:.3g} (tol {TOL})")
        if not err_whole <= TOL:
            fail(f"tiled {engine} path vs whole image: {err_whole} > {TOL}")

    # 5. Times at the main path's shapes, in turns.
    times = {}
    for dtype, pk in ((torch.float32, packed3),
                      (torch.bfloat16, packed3_bf16)):
        times[dtype] = time_in_turns(
            lambda: trunk.fused_trunk_reference(pk, main_x, main_m, 3),
            lambda: trunk.fused_trunk(pk, main_x, main_m, 3))
        mode = "f32" if dtype == torch.float32 else "bf16"
        print(f"{mode} trunk, 24 x 256^2 tiles: kernel {times[dtype][0]:.3f} "
              f"ms, plain {times[dtype][1]:.3f} ms per call (CUDA events, "
              f"2 x 10 calls each; {card})")
    times["d2s"] = time_in_turns(
        lambda: shuffle.depth_to_space_reference(main_expand, 3, main_base),
        lambda: shuffle.depth_to_space_cuda(main_expand, 3,
                                            addend=main_base))
    print(f"depth-to-space(base + expand), (24, 242, 242, 27) f32: kernel "
          f"{times['d2s'][0]:.3f} ms, plain {times['d2s'][1]:.3f} ms per "
          f"call (CUDA events, 2 x 10 calls each; {card})")
    name, x, f, tile, kw = epi_cases[0]
    times["epi"] = time_in_turns(
        lambda: shuffle.epilogue_reference(x, f, tile, h, **kw),
        lambda: shuffle.epilogue_cuda(x, f, tile, h, **kw))
    print(f"epilogue, {name}: kernel {times['epi'][0]:.3f} ms, plain "
          f"{times['epi'][1]:.3f} ms per call (CUDA events, 2 x 10 calls "
          f"each; {card})")
    conv_ms = [0.0, 0.0]
    for name, x, w, odt, timed in conv_cases:
        if timed is None:
            continue
        k_ms, p_ms = time_in_turns(
            lambda: conv_stage.conv_stage_reference(x, w, odt),
            lambda: conv_stage.conv_stage(x, w, odt))
        if timed == "packed":
            conv_ms[0] += k_ms
            conv_ms[1] += p_ms
        print(f"conv stage, {name}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} "
              f"ms per call (CUDA events, 2 x 10 calls each; {card})")
    times["conv"] = tuple(conv_ms)
    print(f"conv stage, the packed tier's five stages (one chunk of 24 "
          f"tiles): kernel {conv_ms[0]:.3f} ms, plain {conv_ms[1]:.3f} ms "
          f"({card})")
    for tier in ("xla exact", "xla fast", "xla fast flat", "fused exact",
                 "fused fast"):
        print(f"CLI {tier}: {walls[tier]:.3f} s wall = "
              f"{hr_mpix / walls[tier]:.2f} HR MPix/s for {lr.shape[1]}x"
              f"{lr.shape[0]} -> {lr.shape[1] * 3}x{lr.shape[0] * 3} (host "
              f"clock, first run in the process; {card})")

    def row(name, source, replaces, count, err, timed):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": count,
                "max_abs_err": err, "ms": timed[0], "plain_ms": timed[1]}

    trunk_src = "rusty_sr_tpu_torch/csrc/trunk.cu"
    trunk_tpu = "rusty_sr_tpu/ops/pallas/trunk.py:134"
    shuffle_src = "rusty_sr_tpu_torch/csrc/shuffle.cu"
    shuffle_tpu = "rusty_sr_tpu/ops/pallas/shuffle.py:20"
    print(json.dumps({"kernels": [
        row("trunk f32", trunk_src, trunk_tpu, launches["f32"],
            max_err[torch.float32], times[torch.float32]),
        row("trunk bf16", trunk_src, trunk_tpu, launches["bf16"],
            max_err[torch.bfloat16], times[torch.bfloat16]),
        row("depth_to_space", shuffle_src, shuffle_tpu, launches["d2s"],
            d2s_err, times["d2s"]),
        row("epilogue u8", shuffle_src, shuffle_tpu, launches["epi"],
            epi_err, times["epi"]),
        row("conv_stage", "rusty_sr_tpu_torch/csrc/conv_stage.cu",
            "scripts/mosaic_probe4.py:49", launches["conv"], conv_err,
            times["conv"])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
