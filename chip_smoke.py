#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`rusty_sr_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of the repository

Phases, each fatal on failure:

1. print the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions and the PNG encoder and decoder in use (with the
   compiler's error where the native codec did not build; the native tile
   library must build);
2. build the kernels from ``rusty_sr_tpu_torch/csrc`` with nvcc;
3. hold each kernel against its plain PyTorch version on the card, at
   the shapes the main paths give it (anime weights, factor 3, a chunk of
   24 tiles of 256^2 padded) plus ragged odd tiles and factor 2: the
   trunk in f32 (atol 1e-5) and in bf16 (max 1e-2, mean 1e-4); the
   depth-to-space kernel (byte-identical) in u8 and f32; the conv-stage
   kernel at the packed fast tier's five stages (24
   tiles of 128^2 packed), the flat fast tier's six convs (24 x 255^2)
   and the shapes of the TPU conv-stage probes (f32 out within 1e-5 of
   the largest plain output; bf16 out within that plus 1 bf16 ulp, with
   at most 1e-3 of the values differing); each stage with its fused
   epilogue as the fast tiers run it (byte-identical to the kernel
   without it followed by the plain glue; against cuDNN plus the plain
   glue, at most 1e-3 of the values beyond 1e-5 of the largest plus 1
   bf16 ulp); the epilogue (byte-identical), which computes the bilinear
   base from the edge tiles: the xla tiers' form (halo crop, base from
   u8 or f32 edge tiles, u8 or f32 out), the fused engine's (crop offset
   0, f32 edge tiles), the packed form, and ragged factor-2 cases;
4. run the CLI end to end on a synthetic 1024x768 PNG, each path with
   the launch counts set to 0 just before it and read just after:
   ``--engine fused -p anime`` (the f32 trunk and the epilogue ran; within
   1 u8 code of the same run through the plain versions), ``--engine
   fused --fast`` (the bf16 trunk and the epilogue ran; within 4 codes of
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
4b. serve a folder of synthetic PNGs (four 1024x768, four ragged sizes,
   ``a.png`` beside ``a.PNG``, one truncated file), each path with the
   counts set to 0 before it: folder mode in the exact tier (the
   epilogue ran), ``--fast`` and ``--fast --tile 241`` (every conv stage
   ran), each output within 1 (exact) or 4 codes of the single-image
   CLI's for the same file; the exact folder through the plain versions
   (1 code) and in one-image groups (byte-identical); ``watch --once
   --metrics`` (the same files, one record); a ``-p bilinear`` folder
   (depth-to-space ran; byte-identical to the single images);
   `tiled_sr_batch` on the images three times over at 8 and 1 chunks in
   flight (byte-identical); then the folder's HR MPix/s, the batch's
   HR MPix/s and the device's busy share under torch.profiler, the peak
   device memory, the PNG encoders' MPix/s and the single-image CLI's
   wall time again;
4c. train on a folder of eight synthetic 512x384 PNGs at full width
   (width 32, x3, crop 192), each counted run with the counts set to 0
   before it: ``train`` through the CLI in the f32 merged tier from the
   anime weights, 30 steps with checkpoints and validation every 10 (the
   epilogue kernel ran in its f32 form; a 1,043,676-byte .rsr; JSONL at
   steps 1, 10, 20, 30) and ``--resume`` to step 35; `train_folder` with
   ``amp`` and with the packed trunk at batch 32, 100 steps each from a
   fresh init (the loss of step 1's batch after them finite and no higher
   than at step 1); one f32 step on the
   card against the CPU (loss rel 1e-5, each gradient leaf 1e-4 of its
   max, parameters after 10 steps atol 1e-4) and against a float64 CPU
   step (1e-4 of each leaf's max: the TF32 witness, beside the same step
   with TF32 allowed); validation PSNR with the epilogue kernel against
   its plain version (1e-6 dB); and ms/step and samples/s of the loop's
   step (a CUDA graph) and of the eager step in turns, their busy shares
   and the convolutions' share of the eager step's kernel time
   (torch.profiler), and the peak memory, for f32, amp and packed at
   batch 4 and 32;
4d. the mesh's data axis and data-parallel training on the one card,
   each counted run with the counts set to 0 before it:
   `tiled_sr_batch` on 4b's images over a mesh of two replicas on cuda:0
   in the exact, packed and flat tiers (byte-identical to one device;
   the epilogue and every conv stage of the tier ran); the CLI with
   ``--mesh data=1`` for a single image, a ``--fast`` folder and ``watch
   --once`` (byte-identical to the runs without it); ``train`` 10 steps
   from anime over NCCL at world size 1 (``--coordinator
   127.0.0.1:P --num_processes 1 --process_id 0``; the .rsr within 1e-6
   of the run without it); two spawned processes on cuda:0 over gloo,
   `train_folder` at batch 8 (4 a rank) for 10 steps (the ranks'
   parameters bit-identical; step 1 within loss rel 1e-5 and parameters
   1e-4 of one process's step on the global batch; rank 0's validation
   launched the epilogue's f32 form); the ms/step of each run, printed
   as a wiring check, not scaling;
4e. the rest of training (`mesh_axes_phase`): ``--precision high``
   against float64 and timed beside f32 and ``--amp``, gloo ranks on
   (1,2,1), (1,1,2) and (1,2,2) meshes on cuda:0 against one process,
   the sharded whole-image net, the CLI with the spatial and model axes;
4f. the variants (`variants_phase`): `tiled_sr` on the CLI image with
   ``trunk="flat"``, ``conv0_s2d=False``, ``conv0_ws=False`` (also at
   tile 241), ``out16=False`` and ``"bcd"``, the fused engine with
   ``packed=`` and ``engine="int8"`` (u8 and f32), each with the counts
   set to 0 before it, against its run through the plain versions (4
   codes fast, 1 exact and int8, ``packed=`` byte-identical to the call
   without it) and the exact tier (45 dB and 8 codes; int8 50 dB); a
   24-tile chunk of each timed by `utils.profiling.device_timer` in turns
   with the packed and default flat tiers; ``torch._int_mm`` at the int8
   stages' shapes bit-identical to the plain integer product, timed
   beside it and its bound (a JSON line ``{"int8_products": ...}``);
4g. SwinIR (`swinir_phase`): ``window_attn_kernel`` against its plain
   version at the SwinIR cell's 544x960 tokens, shift 0 and 4 (max 2e-2,
   mean 2e-3), and on the fast tier's padded rows (544 in with NaN in the
   padding, 192 out: bit-identical to SwinIR's own rows, the padding
   columns zero); ``add_layernorm_kernel`` against its plain version on the
   same tokens at C = 180, in each of the forward's four forms, in place
   and out of place (the sum bit-identical, x untouched out of place, a
   bf16 h within one unit everywhere and identical on 99.9%, an f32 h
   within 16 f32 units); ``swin_mlp_kernel`` against its plain version
   on the same tokens at C = 180, hidden 360 (as
   `tests/test_torch_swin_mlp.py`: every value within one bf16 unit and
   2^-6, the mean gap within 2e-5 of the mean |y|);
   `upscale_batch` on four 960x540 frames with seeded
   SwinIR-M x4 weights on the fast tier, the launch counts set to 0
   before it (36 attention, 80 add-and-normalise and 36 MLP launches a
   chunk of the default one frame), frame 0 within the cell's code-gap
   limits of the reference's float32 upscale, and the SHA-256 of frame 0
   in the fast and the exact tier; each kernel and its plain
   version timed in turns beside its bound (attention at each shift:
   1,440 bytes a token at 3.35 TB/s, and on SwinIR's own rows, the
   padded rows, and padded input rows read 4 bytes a lane, in turns; the
   qkv and proj GEMMs and the group's convolution on SwinIR's own and
   the padded rows, in turns; the add + norm 2,160 bytes a token:
   its plain version is PyTorch's own add, ``F.layer_norm`` and cast, the
   yardstick; the MLP 259,200 FLOP a token at 989 TFLOP/s, with the
   library's bf16 ``F.linear``, ``F.gelu``, ``F.linear`` timed beside it,
   which the port never calls);
4h. HAT (`hat_phase`): ``hat_sa16_kernel`` (shift 0 and 8) and
   ``hat_oca_kernel`` against their plain version at the HAT cell's
   544x960 tokens, 6 heads of 30 (max 2e-2, mean 2e-3); the
   add-and-normalise's three-term form against its plain version (the
   sum bit-identical, h within one bf16 unit); `upscale_batch` on two
   960x540 frames with seeded HAT x4 weights on the fast tier, the launch
   counts set to 0 before it (36 window-16 attention, 6 overlapping
   attention, 42 MLP and 92 add-and-normalise launches a chunk), frame 0
   within the cell's limits, and its SHA-256; each kernel and its plain
   version timed in turns beside its bound, and the branch's cuDNN
   convolution pair timed beside them;
5. time each kernel, its plain version and, where one exists, the one
   PyTorch call for the same function (cuDNN's bf16 conv for the conv
   stage) with CUDA events, in turns, beside its bound (the larger of
   its operations over the card's peak for the route its kernel takes:
   the FMA units for the f32 trunk, the tensor cores for bf16; and its
   bytes over 3.35 TB/s); as a reference figure, cuDNN's five trunk
   convs alone at the trunk's stage extents in each mode's type;
   time one 24-tile chunk of each fast tier with the fused stages and
   with the plain glue between unfused stages (byte-identical outputs);
   one 24-tile chunk of the xla exact tier, the flat fast tier and the
   fused exact engine as they run now and as they ran with the plain
   bilinear base and casts (emulated: the plain base, then the epilogue
   kernel given the base in place of ``expand``, which moves one f32
   tile-sized read fewer than the earlier kernel's addend form did); and
   the CLI runs on the host clock.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists each kernel (the conv stage once per stage of each fast tier, the
window attention once per shift) with
its launches (summed over the CLI, serving, training, multi-device and
variants paths above), error, times and bound.
Without a CUDA device, or outside the repository, it
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


def train_image(rng, h: int, w: int) -> np.ndarray:
    """A training image, as u8 (H, W, 3): flat discs and boxes with hard
    edges over gradients, a fine sinusoidal texture and noise of sigma 1%
    (`synthetic_image`'s 5% noise would set an MSE floor of 0.0025, about
    an untrained net's loss)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([xx / w, yy / h, 0.5 + 0.3 * np.sin(xx / 23.0 + yy / 31.0)],
                   axis=-1)
    for _ in range(24):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(8, 60)
        col = rng.uniform(0, 1, 3).astype(np.float32)
        if rng.random() < 0.5:
            img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = col
        else:
            img[(np.abs(yy - cy) < r)
                & (np.abs(xx - cx) < r * rng.uniform(0.3, 2))] = col
    fr = rng.uniform(0.2, 0.8)
    img += 0.08 * np.sin(xx * fr + yy * fr * 0.7)[..., None]
    img += rng.normal(0.0, 0.01, img.shape)
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


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


def sha256(a) -> str:
    """The first 16 hex digits of the SHA-256 of an array's bytes."""
    import hashlib
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def time_in_turns(plain, kernel, library=None):
    """Mean ms per call of the kernel, the plain version and the library
    call (None without one), timed plain, kernel, library, library,
    kernel, plain after two warm-up calls of each."""
    fns = [plain, kernel] + ([library] if library else [])
    for fn in fns:
        fn()
        fn()
    times = {id(fn): [] for fn in fns}
    for fn in fns + fns[::-1]:
        times[id(fn)].append(cuda_time_ms(fn))
    k_ms, p_ms = sum(times[id(kernel)]) / 2, sum(times[id(plain)]) / 2
    return k_ms, p_ms, (sum(times[id(library)]) / 2 if library else None)


# The card's published peaks (NVIDIA H100 SXM at 700 W, dense).
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12
PEAK_INT8 = 1979e12       # dense int8 tensor-core operations a second


def bound(flops, nbytes, peak=PEAK_BF16):
    """(ms, "operations" or "bytes"): the least time for the work."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors):
    """Bytes of the tensors' elements (each read or written once)."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def conv_flops(x, w):
    """2 * pixels * k^2 * Cin * Cout of a Same conv of x with HWIO w."""
    return 2.0 * x.shape[0] * x.shape[1] * x.shape[2] * w.shape[0] \
        * w.shape[1] * w.shape[2] * w.shape[3]


def cudnn_bf16(x, w):
    """One PyTorch call for the same conv: cuDNN's bf16 `F.conv2d` on the
    NHWC tensors (a channels-last view), bf16 out."""
    import torch.nn.functional as F
    xt, wt, k = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), w.shape[0]
    return lambda: F.conv2d(xt, wt, padding=k // 2)


def bf16_excess_ulps(got, want, f32_bound):
    """|got - want| beyond ``f32_bound``, in bf16 ulps at the larger
    magnitude."""
    import torch
    got, want = got.float(), want.float()
    m = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -126)
    excess = ((got - want).abs() - f32_bound).clamp_min(0.0)
    return excess / torch.exp2(torch.floor(torch.log2(m)) - 7)


def busy_share(prof, wall_s: float):
    """(kernel share, copy share) of ``wall_s``: the union of the CUDA
    kernels' and of the copies' intervals in a torch.profiler run, or
    None where the profiler saw no device event."""
    from torch.autograd import DeviceType
    spans = {"kernel": [], "copy": []}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        kind = "copy" if e.name.startswith(("Memcpy", "Memset")) else "kernel"
        spans[kind].append((e.time_range.start, e.time_range.end))
    if not spans["kernel"]:
        return None

    def union_us(iv):
        total, end = 0.0, None
        for a, b in sorted(iv):
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        return total
    return tuple(union_us(spans[k]) * 1e-6 / wall_s for k in ("kernel",
                                                             "copy"))


def best_of(fn, reps: int = 3) -> float:
    """Least host-clock seconds of ``reps`` calls."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def serving_phase(cli, tiling, imageio, native, anime, rng, card,
                  zero_counts, counts, run_plain, stage_shape, walls):
    """Folder mode, watch and `tiled_sr_batch` on a folder of synthetic
    PNGs: four 1024x768, four ragged sizes, a name collision (a.png and
    a.PNG) and a truncated file.  Returns the launches of the counted
    runs: {"launches": {...}, "epi": {form: n}, "shapes": {key: n}} and the
    readable images, largest first: {"images": [...]}."""
    import io
    import torch
    from rusty_sr_tpu_torch.train.data import list_images

    bf = torch.bfloat16
    got = {"launches": {"f32": 0, "bf16": 0, "d2s": 0, "epi": 0, "conv": 0},
           "epi": {"xla u8": 0, "packed": 0}, "shapes": {}}

    def add(n, form=None):
        for k in got["launches"]:
            got["launches"][k] += n[k]
        if form:
            got["epi"][form] += n["epi"]
        for key, v in n["shapes"].items():
            got["shapes"][key] = got["shapes"].get(key, 0) + v

    def run(argv, what):
        rc = cli.main(argv)
        if rc != 0:
            fail(f"{what} exited {rc}")

    def u8(path):
        return imageio.load_image_u8(path)

    def worst(a, b):
        return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())

    tmp = tempfile.mkdtemp(prefix="chip_smoke_serving_")
    saved_group = cli._GROUP_LR_BYTES
    saved_inflight = tiling._MAX_INFLIGHT
    try:
        src = os.path.join(tmp, "in")
        os.makedirs(src)
        shapes = {f"big{i}.png": (768, 1024) for i in range(4)}
        shapes.update({"r517x300.png": (300, 517), "r131x97.png": (97, 131),
                       "r243x241.png": (241, 243), "r16x16.png": (16, 16),
                       "a.png": (48, 64), "a.PNG": (64, 48)})
        for name, (hh, ww) in shapes.items():
            imageio.save_image_u8(os.path.join(src, name),
                                  synthetic_image(rng, hh, ww))
        trunc = os.path.join(src, "truncated.png")
        imageio.save_image_u8(trunc, synthetic_image(rng, 40, 40))
        with open(trunc, "r+b") as f:
            f.truncate(os.path.getsize(trunc) // 2)
        files = list_images(src)
        readable = [f for f in files if f != trunc]
        names = dict(zip(files, cli._output_names(files)))
        lr_px = sum(h_ * w_ for h_, w_ in shapes.values())
        hr_mpix = lr_px * 9 / 1e6
        print(f"serving folder: {len(files)} files ({len(readable)} "
              f"readable, one truncated; a.png and a.PNG collide -> "
              f"{names[os.path.join(src, 'a.PNG')]}, "
              f"{names[os.path.join(src, 'a.png')]}), {lr_px / 1e6:.3f} LR "
              f"MPix -> {hr_mpix:.3f} HR MPix")

        def out(name):
            return os.path.join(tmp, name)

        def single(flags, tag):
            """The single-image CLI's output for every readable file."""
            ref = {}
            for f in readable:
                o = out(f"{tag}_{os.path.basename(f)}.png")
                run(["-p", "anime", *flags, f, o] if "-p" not in flags
                    else [*flags, f, o], f"single-image CLI {tag} {f}")
                ref[f] = u8(o)
            return ref

        def folder_outputs(d):
            listed = sorted(os.listdir(d))
            want = sorted(names[f] for f in readable)
            if listed != want:
                fail(f"folder output {d}: {listed}, expected {want}")
            return {f: u8(os.path.join(d, names[f])) for f in readable}

        tiers = (("exact", [], ("epi",), 1, "xla u8", None),
                 ("fast", ["--fast"], ("conv", "epi"), 4, "packed", "packed"),
                 ("flat", ["--fast", "--tile", "241"], ("conv", "epi"), 4,
                  "xla u8", "flat"))
        folders = {}
        for tier, flags, must, code_bound, form, stages in tiers:
            d = out(f"folder_{tier}")
            zero_counts()
            t0 = time.time()
            run(["-p", "anime", *flags, src, d], f"folder {tier}")
            n = counts()
            wall = time.time() - t0
            t0 = time.time()
            run(["-p", "anime", *flags, src, out(f"folder_{tier}_again")],
                f"folder {tier}, again")
            wall2 = time.time() - t0
            print(f"folder {tier}: {len(readable)} images, {hr_mpix:.3f} HR "
                  f"MPix in {wall:.3f} s wall = {hr_mpix / wall:.2f} HR "
                  f"MPix/s; run again {wall2:.3f} s = "
                  f"{hr_mpix / wall2:.2f} HR MPix/s (host clock; launches: "
                  f"epilogue {n['epi']}, conv stage {n['conv']}; {card})")
            walls[f"folder {tier}"] = (wall, wall2, hr_mpix)
            for k in must:
                if n[k] < 1:
                    fail(f"folder {tier} launched no {k} kernel")
            for stage, key in stage_shape.items():
                if stage.split()[0] == stages and n["shapes"].get(key, 0) < 1:
                    fail(f"folder {tier} launched no {stage} stage")
            add(n, form)
            folders[tier] = got_t = folder_outputs(d)
            ref = single(flags, tier)
            diffs = {f: worst(got_t[f], ref[f]) for f in readable}
            same = all(got_t[f].tobytes() == ref[f].tobytes()
                       for f in readable)
            print(f"folder {tier} vs the single-image CLI: max "
                  f"{max(diffs.values())} u8 codes over {len(readable)} "
                  f"files (bound {code_bound}); "
                  f"{'byte-identical' if same else 'NOT byte-identical'}")
            if max(diffs.values()) > code_bound:
                fail(f"folder {tier} differs from the single-image CLI: "
                     f"{diffs}")

        run_plain(["-p", "anime", src, out("folder_plain")],
                  "folder exact")
        plain = folder_outputs(out("folder_plain"))
        w_plain = max(worst(folders["exact"][f], plain[f]) for f in readable)
        print(f"folder exact, kernels vs plain versions: max {w_plain} u8 "
              "codes (bound 1)")
        if w_plain > 1:
            fail(f"folder exact vs plain: {w_plain} codes")

        cli._GROUP_LR_BYTES = 1
        run(["-p", "anime", src, out("folder_split")], "folder, 1-image groups")
        cli._GROUP_LR_BYTES = saved_group
        split = folder_outputs(out("folder_split"))
        same = all(split[f].tobytes() == folders["exact"][f].tobytes()
                   for f in readable)
        print(f"folder exact in one-image groups: "
              f"{'byte-identical' if same else 'DIFFERENT'}")
        if not same:
            fail("folder exact in one-image groups differs")

        metrics = out("watch.jsonl")
        zero_counts()
        run(["watch", "-p", "anime", "--once", "--metrics", metrics, src,
             out("watch")], "watch --once")
        n = counts()
        if n["epi"] < 1:
            fail("watch --once launched no epilogue")
        add(n, "xla u8")
        watched = folder_outputs(out("watch"))
        with open(metrics) as f:
            recs = [json.loads(line) for line in f]
        same = all(watched[f].tobytes() == folders["exact"][f].tobytes()
                   for f in readable)
        print(f"watch --once: {'byte-identical to' if same else 'DIFFERENT from'}"
              f" the exact folder run; {len(recs)} metrics record(s): "
              f"{recs}")
        if not same or len(recs) != 1 or recs[0]["images"] != len(readable):
            fail("watch --once disagrees with the folder run or its metrics")

        zero_counts()
        run(["-p", "bilinear", src, out("bilinear")], "folder -p bilinear")
        n = counts()
        if n["d2s"] < 1:
            fail("the bilinear folder launched no depth-to-space kernel")
        add(n)
        bil, ref = folder_outputs(out("bilinear")), single(["-p", "bilinear"],
                                                           "bilinear")
        same = all(bil[f].tobytes() == ref[f].tobytes() for f in readable)
        print(f"folder -p bilinear: {'byte-identical to' if same else 'DIFFERENT from'}"
              f" the single-image runs (launches: depth-to-space {n['d2s']})")
        if not same:
            fail("the bilinear folder differs from the single-image runs")

        # tiled_sr_batch on the folder's images three times over: 276
        # tiles, 12 chunks, so the ring of 9 pinned slots wraps at depth 8.
        got["images"] = sorted((imageio.load_image_u8(f) for f in readable),
                               key=lambda im: -im.size)
        imgs = got["images"] * 3
        hr3 = 3 * hr_mpix
        for cd, tier in ((None, "exact"), (bf, "fast")):
            runs = {}
            for depth in (8, 1):
                tiling._MAX_INFLIGHT = depth
                runs[depth] = tiling.tiled_sr_batch(anime, imgs, 3,
                                                    compute_dtype=cd)
            tiling._MAX_INFLIGHT = saved_inflight
            same = all(a.tobytes() == b.tobytes()
                       for a, b in zip(runs[1], runs[8]))
            print(f"tiled_sr_batch {tier}, {len(imgs)} images: in-flight 8 "
                  f"and 1 {'byte-identical' if same else 'DIFFERENT'}")
            if not same:
                fail(f"tiled_sr_batch {tier}: outputs depend on the "
                     "in-flight depth")
            del runs

            def batch():
                tiling.tiled_sr_batch(anime, imgs, 3, compute_dtype=cd)
                torch.cuda.synchronize()
            ts = sum(best_of(batch, 1) for _ in range(2)) / 2
            print(f"tiled_sr_batch {tier}, {len(imgs)} images ({hr3:.2f} HR "
                  f"MPix): {ts:.4f} s = {hr3 / ts:.1f} HR MPix/s (host "
                  f"clock, mean of 2; {card})")
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                batch()
                wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
            share = busy_share(prof, wall)
            # The profiler lengthens the wall by a varying amount; the
            # kernels' own time does not vary, so it is also given over
            # the untraced wall above.
            busy = ("not measured (the profiler saw no device event)"
                    if share is None else f"kernels {share[0]:.1%}, copies "
                    f"{share[1]:.1%} of {wall:.4f} s (kernels "
                    f"{share[0] * wall:.4f} s = {share[0] * wall / ts:.1%} "
                    f"of the untraced {ts:.4f} s)")
            print(f"tiled_sr_batch {tier} under torch.profiler: device busy "
                  f"{busy}; peak device memory {peak / 2**30:.3f} GiB "
                  f"above the {base / 2**30:.3f} GiB held before the call "
                  f"(max_memory_allocated; {card})")
            walls[f"busy {tier}"] = (share, wall, peak)

        # The encoders on one HR image of the exact folder run.
        big0 = os.path.join(src, "big0.png")
        hr = folders["exact"][big0]
        mp = hr.shape[0] * hr.shape[1] / 1e6
        rates = {}
        if native.png_available():
            rates["native fh, 1 thread"] = best_of(
                lambda: native.png_encode(hr, threads=1))
            rates["native fh, auto threads"] = best_of(
                lambda: native.png_encode(hr, threads=0))
        else:
            print("native PNG codec unavailable: "
                  f"{native.build_error('png') or 'no compiler'}")
        try:
            from PIL import Image

            def pil():
                Image.fromarray(hr).convert("RGBA").save(
                    io.BytesIO(), "PNG", compress_level=1)
            rates["Pillow (zlib 1)"] = best_of(pil, 2)
        except ImportError:
            pass
        rates["stdlib zlib 1"] = best_of(lambda: imageio.png_encode(hr), 2)
        print(f"PNG encode of one {hr.shape[1]}x{hr.shape[0]} HR image: "
              + "; ".join(f"{k} {s * 1e3:.1f} ms = {mp / s:.1f} MPix/s"
                          for k, s in rates.items())
              + f" (host clock, best of 3 or 2; {os.cpu_count()} cores; "
              f"{card})")
        walls["encode"] = (rates, mp)

        t0 = time.time()
        run(["-p", "anime", big0, out("single_again.png")],
            "single-image CLI, again")
        wall = time.time() - t0
        print(f"single-image xla exact CLI, 1024x768: first run in the "
              f"process {walls['xla exact']:.3f} s, run again {wall:.3f} s "
              f"(host clock; {card})")
    finally:
        cli._GROUP_LR_BYTES = saved_group
        tiling._MAX_INFLIGHT = saved_inflight
        shutil.rmtree(tmp, ignore_errors=True)
    return got


def step_flops(batch: int, crop: int, packed: bool, n: int = 32,
               e: int = 27) -> float:
    """Operations of one training step's convolutions: the forward's
    2 * pixels * sum(k^2 * Cin * Cout) at the LR side crop/3, and twice
    that again for the backward (input and weight gradients; conv0's
    input gradient, which is not needed, included).  The packed trunk
    runs every conv as 3x3 taps over the 2x2 space-to-depth grid, which
    counts the zero taps too: 144/100 of a 5x5 conv's products and 144/36
    of a 3x3's."""
    taps = ((25, 3, n), (25, n, 3 * n), (9, n, 2 * n + e), (9, n, n + e),
            (9, n, e))
    px = batch * (crop // 3) ** 2
    if packed:
        macs = sum(144 / 4 * ci * co for _, ci, co in taps)
    else:
        macs = sum(k * ci * co for k, ci, co in taps)
    return 3 * 2.0 * px * macs


def training_phase(cli, tiling, shuffle, params, imageio, rng, card,
                   zero_counts, counts):
    """Training on a folder of eight synthetic 512x384 PNGs: the CLI's
    f32 merged run at full width with resume, `api.train_folder` with
    --amp and --trunk packed --batch 32, the card's step against the CPU's
    and against float64, validation with the epilogue kernel against its
    plain version, and the step times.  Returns the launches of the
    counted runs: {"epi": n}."""
    import contextlib
    import io
    import torch
    from rusty_sr_tpu_torch import api
    from rusty_sr_tpu_torch.ops.conv import tf32_on_bf16
    from rusty_sr_tpu_torch.train import checkpoint as ck
    from rusty_sr_tpu_torch.train import loop as TL
    from rusty_sr_tpu_torch.train.data import CropPipeline

    dev = torch.device("cuda")
    got = {"epi": 0}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        src = os.path.join(tmp, "in")
        os.makedirs(src)
        for i in range(8):
            imageio.save_image_u8(os.path.join(src, f"t{i}.png"),
                                  train_image(rng, 384, 512))
        anime_rsr = os.path.join(params._builtin_dir(), "anime.rsr")

        def out(name):
            return os.path.join(tmp, name)

        def train_cli(argv, what):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["train", *argv])
            text = buf.getvalue()
            print("\n".join("  | " + ln for ln in text.splitlines()))
            if rc != 0:
                fail(f"train CLI {what} exited {rc}")
            return text

        # 1. The CLI, f32 merged, full width, from the anime weights.
        ckd, mjs, rsr = out("ck"), out("m.jsonl"), out("out.rsr")
        zero_counts()
        t0 = time.time()
        train_cli([rsr, src, "-s", anime_rsr, "-v", src, "-m", "2",
                   "--max_steps", "30", "--ckpt_every", "10", "--val_every",
                   "10", "--ckpt_dir", ckd, "--metrics", mjs], "f32 merged")
        wall = time.time() - t0
        n = counts()
        got["epi"] += n["epi"]
        with open(mjs) as f:
            recs = [json.loads(line) for line in f]
        size = os.path.getsize(rsr)
        params.load_rsr_file(rsr, 3)
        print(f"train CLI f32 merged, 30 steps of batch 4, crop 192, "
              f"validation on 2 images every 10: {wall:.2f} s wall (host "
              f"clock, the process's first training run); .rsr {size} "
              f"bytes; epilogue launches {n['epi']}; JSONL steps "
              f"{[r['step'] for r in recs]}, losses "
              f"{[round(r['loss'], 6) for r in recs]}, val PSNR "
              f"{[round(r.get('val_psnr', float('nan')), 4) for r in recs]}")
        if size != 1_043_676 or [r["step"] for r in recs] != [1, 10, 20, 30] \
                or not all(np.isfinite(r.get("val_psnr", np.nan))
                           for r in recs):
            fail("the train CLI's .rsr or metrics are wrong")
        if n["epi"] < 1:
            fail("training's validation launched no epilogue kernel")
        zero_counts()
        text = train_cli([rsr, src, "--ckpt_every", "10", "--ckpt_dir", ckd,
                          "--max_steps", "35", "--resume"], "resume")
        got["epi"] += counts()["epi"]
        last = ck.latest_native(ckd)
        print(f"train CLI --resume --max_steps 35: latest checkpoint "
              f"{os.path.basename(last)}")
        if "Resumed from" not in text or "at step 30" not in text or \
                not last.endswith("step_00000035"):
            fail("the train CLI did not resume from step 30 to step 35")

        # 2. --amp, then --trunk packed --batch 32, through the API, from a
        # fresh init at full width.  The reference's Adam first raises the
        # loss of an untrained net (its first steps move every weight by
        # about the learning rate) and takes ~50 steps to bring it back
        # below step 1's (measured on the CPU), so each runs 100 steps,
        # and the loss compared is that of step 1's batch (the feed's
        # first, from its seed) before and after, free of the batches'
        # spread.
        init = params.init_params(SEED, 3)
        for name, kw in (("--amp", dict(amp=True)),
                         ("--trunk packed --batch 32",
                          dict(trunk="packed", batch_size=32))):
            mf = out(name.replace(" ", "").replace("-", "") + ".jsonl")
            c = TL.TrainConfig(**kw)
            zero_counts()
            t0 = time.time()
            tree = api.train_folder(src, steps=100, start=init,
                                    metrics_file=mf, checkpoint_every=20,
                                    device="cuda", **kw)
            wall = time.time() - t0
            got["epi"] += counts()["epi"]
            with open(mf) as f:
                recs = [json.loads(line) for line in f]
            pipe = CropPipeline(src, crop=(192, 192),
                                batch_size=c.batch_size, seed=0,
                                out_dtype=np.uint8)
            try:
                b1 = torch.from_numpy(pipe.next_batch()).to(dev)
            finally:
                pipe.close()
            with torch.no_grad(), TL.step_precision(c):
                before, after = (float(TL.loss_fn(params.to_torch(t, dev),
                                                  b1, c)[0])
                                 for t in (init, tree))
            print(f"train_folder {name}, 100 steps: {wall:.2f} s wall (host "
                  f"clock); losses at steps {[r['step'] for r in recs]}: "
                  f"{[round(r['loss'], 6) for r in recs]}; step 1's batch "
                  f"{before:.6g} before, {after:.6g} after")
            if not (abs(recs[0]["loss"] - before) <= 1e-5 * before
                    and np.isfinite(after) and after <= before
                    and all(np.isfinite(v).all() for v in tree.values())):
                fail(f"train_folder {name} did not reduce the loss")

        # 3. The card's f32 step against the CPU's (the plain path), and
        # against float64 (the TF32 witness).
        cfg = TL.TrainConfig()
        pipe = CropPipeline(src, crop=(192, 192), batch_size=32, seed=SEED,
                            workers=4, out_dtype=np.uint8)
        try:
            big = pipe.next_batch()
            small_batches = [pipe.next_batch()[:4] for _ in range(10)]
        finally:
            pipe.close()

        def run_steps(device, dtype, batches, ctx=None):
            """The training loop's step (`make_train_step`: on the card its
            CUDA graph, on the CPU the plain step), or with ``ctx`` the
            eager step with that conv precision in place of its own."""
            p = {k: torch.tensor(v, dtype=dtype, device=device,
                                 requires_grad=True) for k, v in init.items()}
            step, opt = TL.make_train_step(cfg, p)
            first = None
            for hr in batches:
                x = torch.from_numpy(hr).to(device)
                if dtype == torch.float64:
                    x = (x.float() * (1.0 / 255.0)).double()
                if ctx is None:
                    loss, _ = step(x)
                else:
                    opt.zero_grad(set_to_none=True)
                    with ctx():
                        loss, _ = TL.loss_fn(p, x, cfg)
                        loss.backward()
                    opt.step()
                if first is None:
                    first = (float(loss.detach()),
                             {k: v.grad.double().cpu().numpy()
                              for k, v in p.items()})
            return first, {k: v.detach().double().cpu().numpy()
                           for k, v in p.items()}

        (l_card, g_card), p_card = run_steps(dev, torch.float32,
                                             small_batches)
        (l_cpu, g_cpu), p_cpu = run_steps("cpu", torch.float32,
                                          small_batches)
        (l_64, g_64), _ = run_steps("cpu", torch.float64, small_batches[:1])
        (_, g_tf32), _ = run_steps(dev, torch.float32, small_batches[:1],
                                   tf32_on_bf16)

        def leaf_err(a, b):
            return max(float(np.abs(a[k] - b[k]).max())
                       / float(np.abs(b[k]).max()) for k in b)
        rel = abs(l_card - l_cpu) / abs(l_cpu)
        g_err, g64_err, tf32_err = (leaf_err(g_card, g_cpu),
                                    leaf_err(g_card, g_64),
                                    leaf_err(g_tf32, g_64))
        p_err = max(float(np.abs(p_card[k] - p_cpu[k]).max()) for k in init)
        print(f"f32 step, card vs CPU (init_params({SEED}, 3), batch 4, crop "
              f"192): loss {l_card:.8g} vs {l_cpu:.8g} (rel {rel:.3g}, tol "
              f"1e-5); worst gradient leaf {g_err:.3g} of its max (tol "
              f"1e-4); parameters after 10 steps max abs {p_err:.3g} (tol "
              f"1e-4)")
        print(f"TF32 witness: the card's f32 gradients vs a float64 CPU "
              f"step: worst leaf {g64_err:.3g} of its max (tol 1e-4); the "
              f"same step with TF32 allowed: {tf32_err:.3g}")
        if not (rel <= 1e-5 and g_err <= 1e-4 and p_err <= 1e-4
                and g64_err <= 1e-4):
            fail("the card's f32 training step disagrees with the CPU or "
                 "with float64")
        # Phase 4e holds --precision high to the same float64 step.
        got["ref"] = {"init": init, "big": big, "batch": small_batches[0],
                      "loss64": l_64, "grad64": g_64}

        # 4. Validation with the epilogue kernel against its plain version.
        val = [imageio.load_image_u8(os.path.join(src, f"t{i}.png"))
               .astype(np.float32) / 255.0 for i in range(2)]
        host = params.load_rsr_file(rsr, 3)
        psnr_k = TL.validation_psnr(host, val, cfg, device=dev)
        saved = tiling.epilogue_cuda
        tiling.epilogue_cuda = shuffle.epilogue_reference
        try:
            psnr_p = TL.validation_psnr(host, val, cfg, device=dev)
        finally:
            tiling.epilogue_cuda = saved
        psnr_c = TL.validation_psnr(host, val, cfg, device="cpu")
        print(f"validation PSNR, 2 images: kernel {psnr_k!r} dB, plain "
              f"version {psnr_p!r} dB (tol 1e-6), CPU {psnr_c!r} dB")
        if not abs(psnr_k - psnr_p) <= 1e-6 or not abs(psnr_k - psnr_c) \
                <= 1e-3:
            fail("validation PSNR through the kernel disagrees")

        # 5. Step times of the loop's step (its CUDA graph) and of the
        # plain eager step, in turns per batch size; under torch.profiler
        # the busy share of each and the convolutions' share of the eager
        # step's kernel time (a graph's replay runs no framework ops to
        # attribute kernels to); the peak memory of the graphed step.
        tiers = (("f32", dict()), ("--amp", dict(amp=True)),
                 ("--trunk packed", dict(trunk="packed")))
        rows = {}
        for bsz in (4, 32):
            x = torch.from_numpy(big[:bsz]).to(dev)
            states = {}
            for name, kw in tiers:
                c = TL.TrainConfig(batch_size=bsz, **kw)
                pe = {k: torch.tensor(v, device=dev, requires_grad=True)
                      for k, v in init.items()}
                oe = TL.make_optimizer(c, pe)
                pg = {k: torch.tensor(v, device=dev, requires_grad=True)
                      for k, v in init.items()}
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                graph, _ = TL.make_train_step(c, pg)
                for _ in range(5):
                    graph(x)
                torch.cuda.synchronize()
                rows[(name, bsz)] = {
                    "peak": torch.cuda.max_memory_allocated() - base}
                for _ in range(5):
                    TL.train_step(pe, oe, x, c)
                states[name] = {
                    "graph": lambda g=graph: g(x),
                    "eager": lambda p=pe, o=oe, c=c: TL.train_step(p, o, x,
                                                                   c)}
            order = [(n, m) for n, _ in tiers for m in ("graph", "eager")]
            ms = {key: [] for key in order}
            for n, m in order + order[::-1]:
                ms[(n, m)].append(cuda_time_ms(states[n][m], iters=20))
            for name, _ in tiers:
                r = rows[(name, bsz)]
                for mode in ("graph", "eager"):
                    with torch.profiler.profile(activities=[
                            torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
                        t0 = time.perf_counter()
                        for _ in range(10):
                            states[name][mode]()
                        torch.cuda.synchronize()
                        wall = time.perf_counter() - t0
                    share = busy_share(prof, wall)
                    r[mode] = sum(ms[(name, mode)]) / 2
                    r["busy " + mode] = None if share is None else share[0]
                    if mode == "eager":
                        conv_us = sum(
                            getattr(e, "device_time_total",
                                    getattr(e, "cuda_time_total", 0))
                            for e in prof.key_averages()
                            if e.key in ("aten::convolution",
                                         "aten::convolution_backward"))
                        r["conv"] = (None if share is None else
                                     conv_us * 1e-6 / (share[0] * wall))
                flops = step_flops(bsz, 192, name == "--trunk packed")
                r["bound"] = (flops / PEAK_F32 * 1e3, flops / PEAK_BF16 * 1e3)

                def pct(v):
                    return "not measured" if v is None else f"{v:.1%}"
                print(f"train step {name}, batch {bsz}, crop 192: CUDA graph "
                      f"{r['graph']:.3f} ms/step = "
                      f"{bsz / r['graph'] * 1e3:.1f} samples/s, eager "
                      f"{r['eager']:.3f} ms/step = "
                      f"{bsz / r['eager'] * 1e3:.1f} samples/s (CUDA events, "
                      f"2 x 20 steps in turns); busy (torch.profiler, 10 "
                      f"steps) graph {pct(r['busy graph'])}, eager "
                      f"{pct(r['busy eager'])}; convolutions "
                      f"{pct(r.get('conv'))} of the eager step's kernel "
                      f"time; peak memory {r['peak'] / 2**20:.1f} MiB above "
                      f"the {base / 2**20:.1f} MiB held before; bound "
                      f"{r['bound'][0]:.3f} ms at 67 TFLOP/s f32, "
                      f"{r['bound'][1]:.4f} ms at 989 TFLOP/s bf16 "
                      f"({flops / 1e9:.2f} GFLOP; {card})")
            del states
        print(f"training phase: epilogue launches {got['epi']} (counted runs: "
              f"the CLI's validation)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return got


def _dp_rank(rank: int, port: int, src: str, tmp: str) -> None:
    """One rank of phase 4d's two-process run (a spawned process): gloo on
    cuda:0, `api.train_folder` at batch 8 (4 a rank) for 10 steps from
    the anime weights, validation at step 1 on rank 0; writes its final
    parameters, its epilogue launches and its wall to rank<r>.npz."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    import torch.distributed as dist
    from rusty_sr_tpu_torch import api, params
    from rusty_sr_tpu_torch.ops.cuda import shuffle

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    try:
        shuffle.EPILOGUE_LAUNCHES = 0
        t0 = time.time()
        tree = api.train_folder(
            src, steps=10, start=os.path.join(params._builtin_dir(),
                                              "anime.rsr"),
            batch_size=8, crop=192, val_folder=src, val_max=2,
            ckpt_dir=os.path.join(tmp, "dp_ck"), checkpoint_every=10,
            metrics_file=os.path.join(tmp, "dp.jsonl"), device="cuda:0",
            group=dist.group.WORLD)
        torch.cuda.synchronize()
        np.savez(os.path.join(tmp, f"rank{rank}.npz"),
                 epi=shuffle.EPILOGUE_LAUNCHES, wall=time.time() - t0,
                 **{"p_" + k: v for k, v in tree.items()})
    finally:
        dist.destroy_process_group()


def multi_device_phase(cli, tiling, imageio, params, anime, images, rng,
                       card, zero_counts, counts, stage_shape):
    """Phase 4d, the mesh's data axis and data-parallel training on the one
    card: `tiled_sr_batch` over two replicas on cuda:0, the CLI with
    ``--mesh data=1``, ``train`` over NCCL at world size 1 and two gloo
    ranks of `train_folder` on cuda:0.  Returns the launches of the
    counted runs: {"launches": {...}, "epi": {form: n}, "shapes": {...}}."""
    import contextlib
    import io
    import multiprocessing
    import socket
    import torch
    from rusty_sr_tpu_torch.parallel.mesh import make_mesh
    from rusty_sr_tpu_torch.train import checkpoint as ck
    from rusty_sr_tpu_torch.train import loop as TL
    from rusty_sr_tpu_torch.train.data import CropPipeline

    got = {"launches": {"f32": 0, "bf16": 0, "d2s": 0, "epi": 0, "conv": 0},
           "epi": {"xla u8": 0, "packed": 0, "xla f32": 0}, "shapes": {}}

    def add(n, form):
        for k in got["launches"]:
            got["launches"][k] += n[k]
        got["epi"][form] += n["epi"]
        for key, v in n["shapes"].items():
            got["shapes"][key] = got["shapes"].get(key, 0) + v

    def free_port():
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            return sock.getsockname()[1]

    def quiet(argv, what):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        if rc != 0:
            fail(f"{what} exited {rc}:\n{buf.getvalue()}")
        return buf.getvalue()

    # 1. tiled_sr_batch over two replicas on the card, each tier.
    mesh = make_mesh(devices=["cuda:0", "cuda:0"])
    hr = sum(im.shape[0] * im.shape[1] for im in images) * 9 / 1e6
    for tier, cd, tile, form, stages in (
            ("exact", None, 242, "xla u8", None),
            ("fast", torch.bfloat16, 242, "packed", "packed"),
            ("flat", torch.bfloat16, 241, "xla u8", "flat")):
        t0 = time.time()
        single = tiling.tiled_sr_batch(anime, images, 3, tile=tile,
                                       compute_dtype=cd)
        wall1 = time.time() - t0
        zero_counts()
        t0 = time.time()
        sharded = tiling.tiled_sr_batch(anime, images, 3, tile=tile,
                                        compute_dtype=cd, mesh=mesh)
        n = counts()
        wall2 = time.time() - t0
        same = all(a.tobytes() == b.tobytes() for a, b in zip(single,
                                                             sharded))
        print(f"tiled_sr_batch {tier} over a mesh of two replicas on "
              f"cuda:0, {len(images)} images: "
              f"{'byte-identical to' if same else 'DIFFERENT from'} one "
              f"device; launches: epilogue {n['epi']}, conv stage "
              f"{n['conv']}; {wall2:.4f} s against {wall1:.4f} s on one "
              f"device = {hr / wall2:.1f} HR MPix/s (host clock, after the "
              f"single run: a wiring check, not scaling; {card})")
        if not same:
            fail(f"tiled_sr_batch {tier} over two replicas differs")
        if n["epi"] < 1:
            fail(f"tiled_sr_batch {tier} over two replicas launched no "
                 "epilogue")
        for stage, key in stage_shape.items():
            if stage.split()[0] == stages and n["shapes"].get(key, 0) < 1:
                fail(f"tiled_sr_batch {tier} over two replicas launched no "
                     f"{stage} stage")
        add(n, form)
    del single, sharded

    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        def out(name):
            return os.path.join(tmp, name)

        # 2. The CLI with --mesh data=1: a single image, a folder, watch.
        src = out("in")
        os.makedirs(src)
        for i, im in enumerate(images[:1] + images[-3:]):
            imageio.save_image_u8(os.path.join(src, f"im{i}.png"), im)
        one = os.path.join(src, "im0.png")
        for what, argv, form in (
                ("single image", ["-p", "anime", one], "xla u8"),
                ("folder --fast", ["-p", "anime", "--fast", src], "packed"),
                ("watch --once", ["watch", "--once", "-p", "anime", src],
                 "xla u8")):
            tag = what.split()[0]
            dst = out(f"{tag}_plain" + (".png" if tag == "single" else ""))
            quiet([*argv, dst], f"CLI {what}")
            zero_counts()
            mesh_dst = out(f"{tag}_mesh" + (".png" if tag == "single"
                                            else ""))
            rest = argv[1:] if argv[0] == "watch" else argv
            quiet(([argv[0]] if argv[0] == "watch" else [])
                  + ["--mesh", "data=1", *rest, mesh_dst],
                  f"CLI {what} --mesh data=1")
            n = counts()
            if tag == "single":
                same = imageio.load_image_u8(dst).tobytes() == \
                    imageio.load_image_u8(mesh_dst).tobytes()
            else:
                names = sorted(os.listdir(dst))
                same = names == sorted(os.listdir(mesh_dst)) and all(
                    imageio.load_image_u8(os.path.join(dst, f)).tobytes()
                    == imageio.load_image_u8(os.path.join(mesh_dst, f))
                    .tobytes() for f in names)
            print(f"CLI {what} --mesh data=1: "
                  f"{'byte-identical to' if same else 'DIFFERENT from'} the "
                  f"run without it (launches: epilogue {n['epi']}, conv "
                  f"stage {n['conv']})")
            if not same or n["epi"] < 1:
                fail(f"CLI {what} --mesh data=1 disagrees or launched no "
                     "epilogue")
            add(n, form)

        # 3. train over NCCL at world size 1 against the same run without
        # a process group: 10 steps from the anime weights.
        ti = out("ti")
        os.makedirs(ti)
        for i in range(4):
            imageio.save_image_u8(os.path.join(ti, f"t{i}.png"),
                                  train_image(rng, 384, 512))
        anime_rsr = os.path.join(params._builtin_dir(), "anime.rsr")
        trees, rates = {}, {}
        for name, extra in (("one process", []),
                            ("NCCL, world 1", [
                                "--coordinator", f"127.0.0.1:{free_port()}",
                                "--num_processes", "1", "--process_id",
                                "0"])):
            rsr, mjs = out(f"{len(extra)}.rsr"), out(f"{len(extra)}.jsonl")
            zero_counts()
            quiet(["train", rsr, ti, "-s", anime_rsr, "--max_steps", "10",
                   "--ckpt_every", "9", "--metrics", mjs, *extra],
                  f"train CLI, {name}")
            add(counts(), "xla f32")
            trees[name] = params.load_rsr_file(rsr, 3)
            with open(mjs) as f:
                recs = {r["step"]: r for r in map(json.loads, f)}
            rates[name] = (recs[9]["wall_s"] - recs[1]["wall_s"]) / 8 * 1e3
        err = max(float(np.abs(trees["one process"][k]
                               - trees["NCCL, world 1"][k]).max())
                  for k in trees["one process"])
        print(f"train CLI over NCCL at world size 1, 10 steps of batch 4: "
              f".rsr within {err:.3g} of the run without a process group "
              f"(tol 1e-6); {rates['NCCL, world 1']:.3f} ms/step against "
              f"{rates['one process']:.3f} (steps 2-9, host clock from "
              f"the metrics: a wiring check, not scaling; {card})")
        if not err <= 1e-6:
            fail(f"train over NCCL at world size 1 differs by {err}")

        # 4. Two gloo ranks on cuda:0, batch 8 (4 a rank), 10 steps.
        ctx = multiprocessing.get_context("spawn")
        port = free_port()
        procs = [ctx.Process(target=_dp_rank, args=(r, port, ti, tmp))
                 for r in range(2)]
        t0 = time.time()
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout=300)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join()
        wall = time.time() - t0
        if any(p.exitcode != 0 for p in procs):
            fail(f"the two gloo ranks exited {[p.exitcode for p in procs]}")
        r0, r1 = (np.load(out(f"rank{r}.npz")) for r in range(2))
        names = [k for k in r0.files if k.startswith("p_")]
        same = all(r0[k].tobytes() == r1[k].tobytes() for k in names)
        with open(out("dp.jsonl")) as f:
            recs = {r["step"]: r for r in map(json.loads, f)}
        ms = (recs[10]["wall_s"] - recs[1]["wall_s"]) / 9 * 1e3
        # Step 1 against one process's step on the global batch.
        cfg = TL.TrainConfig(batch_size=8)
        halves = []
        for r in range(2):
            pipe = CropPipeline(ti, crop=(192, 192), batch_size=4, seed=r,
                                out_dtype=np.uint8, shard_across_hosts=True,
                                process_index=r, process_count=2)
            try:
                halves.append(pipe.next_batch())
            finally:
                pipe.close()
        start = params.load_rsr_file(anime_rsr, 3)
        p1 = {k: torch.tensor(v, device="cuda", requires_grad=True)
              for k, v in start.items()}
        step, _ = TL.make_train_step(cfg, p1)
        loss1, _ = step(torch.from_numpy(np.concatenate(halves)).cuda())
        tree1, _, _ = ck.restore_native(os.path.join(tmp, "dp_ck",
                                                     "step_00000001"))
        p_err = max(float(np.abs(tree1[k] - p1[k].detach().cpu().numpy())
                          .max()) for k in start)
        l_rel = abs(recs[1]["loss"] - float(loss1)) / float(loss1)
        print(f"two gloo ranks on cuda:0, train_folder batch 8 (4 a rank), "
              f"10 steps: parameters of the ranks "
              f"{'bit-identical' if same else 'DIFFERENT'}; step 1 against "
              f"one process's step on the global batch: loss rel "
              f"{l_rel:.3g} (tol 1e-5), parameters max abs {p_err:.3g} (tol "
              f"1e-4); rank 0's validation launched the epilogue "
              f"{int(r0['epi'])} times; {ms:.3f} ms/step (steps 2-10, host "
              f"clock from the metrics; {wall:.1f} s wall with both "
              f"processes' start: a wiring check, not scaling; {card})")
        if not (same and l_rel <= 1e-5 and p_err <= 1e-4
                and int(r0["epi"]) >= 1):
            fail("the two gloo ranks disagree with each other or with one "
                 "process, or validated without the epilogue kernel")
        got["epi"]["xla f32"] += int(r0["epi"]) + int(r1["epi"])
        got["launches"]["epi"] += int(r0["epi"]) + int(r1["epi"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return got


def _mesh_rank(rank: int, world: int, n_spatial: int, n_model: int,
               port: int, src: str, out: str) -> None:
    """One rank of phase 4e's mesh runs (a spawned process): gloo on
    cuda:0, `api.train_folder` at batch 4, crop 192, 10 steps from the
    anime weights on a (world / S / M, S, M) mesh, checkpoints at steps 1
    and 10, validation at step 1 on rank 0; writes its final parameters,
    its epilogue launches and its wall to ``out + rank<r>.npz``."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    import torch.distributed as dist
    from rusty_sr_tpu_torch import api, params
    from rusty_sr_tpu_torch.ops.cuda import shuffle

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        shuffle.EPILOGUE_LAUNCHES = 0
        t0 = time.time()
        tree = api.train_folder(
            src, steps=10, start=os.path.join(params._builtin_dir(),
                                              "anime.rsr"),
            batch_size=4, crop=192, val_folder=src, val_max=2,
            ckpt_dir=out + "ck", checkpoint_every=10, param_file=out + ".rsr",
            metrics_file=out + ".jsonl", device="cuda:0",
            group=dist.group.WORLD, n_spatial=n_spatial, n_model=n_model)
        torch.cuda.synchronize()
        np.savez(f"{out}rank{rank}.npz", epi=shuffle.EPILOGUE_LAUNCHES,
                 wall=time.time() - t0,
                 **{"p_" + k: v for k, v in tree.items()})
    finally:
        dist.destroy_process_group()


def mesh_axes_phase(cli, imageio, params, anime, images, rng, card,
                    zero_counts, counts, stage_shape, ref):
    """Phase 4e, the rest of training on the one card: ``--precision
    high`` (its step against float64, its graphed step timed in turns
    with f32 and ``--amp`` at batch 4 and 32, the CLI's train with
    validation); the mesh's spatial and model axes as gloo ranks of
    `train_folder` on cuda:0, (1, 2, 1), (1, 1, 2) and (1, 2, 2), each
    against one process on the same batches; `make_sharded_apply` over
    four entries of cuda:0 as (2, 2, 1) against the whole batch; and the
    CLI with ``--mesh data=1,spatial=2`` and ``data=1,model=2`` against
    no mesh.  ``ref``: phase 4c's init, batches and float64 step.
    Returns the launches of the counted runs, as phase 4d's."""
    import contextlib
    import io
    import multiprocessing
    import socket
    import torch
    from rusty_sr_tpu_torch import api
    from rusty_sr_tpu_torch.models.sr_net import sr_apply
    from rusty_sr_tpu_torch.parallel import mesh as M
    from rusty_sr_tpu_torch.train import checkpoint as ck
    from rusty_sr_tpu_torch.train import loop as TL

    dev = torch.device("cuda")
    got = {"launches": {"f32": 0, "bf16": 0, "d2s": 0, "epi": 0, "conv": 0},
           "epi": {"xla u8": 0, "packed": 0, "xla f32": 0}, "shapes": {},
           "high": {}}

    def add(n, form):
        for k in got["launches"]:
            got["launches"][k] += n[k]
        got["epi"][form] += n["epi"]
        for key, v in n["shapes"].items():
            got["shapes"][key] = got["shapes"].get(key, 0) + v

    def free_port():
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            return sock.getsockname()[1]

    def quiet(argv, what):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        if rc != 0:
            fail(f"{what} exited {rc}:\n{buf.getvalue()}")
        return buf.getvalue()

    def leaf_err(a, b):
        return max(float(np.abs(a[k] - b[k]).max())
                   / float(np.abs(b[k]).max()) for k in b)

    # 1. --precision high: the card's graphed step against float64.
    init, hi = ref["init"], TL.TrainConfig(precision="high")
    p = {k: torch.tensor(v, device=dev, requires_grad=True)
         for k, v in init.items()}
    step, _ = TL.make_train_step(hi, p)
    loss, _ = step(torch.from_numpy(ref["batch"]).to(dev))
    g_high = {k: v.grad.double().cpu().numpy() for k, v in p.items()}
    g_err = leaf_err(g_high, ref["grad64"])
    l_rel = abs(float(loss) - ref["loss64"]) / abs(ref["loss64"])
    got["high"]["grad64"] = g_err
    print(f"--precision high step (its CUDA graph; init_params({SEED}, 3), "
          f"batch 4, crop 192) vs the float64 CPU step: loss rel "
          f"{l_rel:.3g} (tol 1e-5), worst gradient leaf {g_err:.3g} of its "
          f"max (tol 1e-4; phase 4c's f32 and TF32 figures above)")
    if not (l_rel <= 1e-5 and g_err <= 1e-4):
        fail("the --precision high step disagrees with float64")

    # 2. Step times of the graphed step, f32 / --amp / high in turns; the
    # high tier's eager step, its busy share, conv share and peak memory.
    tiers = (("f32", dict()), ("--amp", dict(amp=True)),
             ("--precision high", dict(precision="high")))
    for bsz in (4, 32):
        x = torch.from_numpy(ref["big"][:bsz]).to(dev)
        steps, peak = {}, {}
        for name, kw in tiers:
            c = TL.TrainConfig(batch_size=bsz, **kw)
            pg = {k: torch.tensor(v, device=dev, requires_grad=True)
                  for k, v in init.items()}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            graph, _ = TL.make_train_step(c, pg)
            for _ in range(5):
                graph(x)
            torch.cuda.synchronize()
            peak[name] = torch.cuda.max_memory_allocated() - base
            steps[name] = lambda g=graph: g(x)
        pe = {k: torch.tensor(v, device=dev, requires_grad=True)
              for k, v in init.items()}
        hc = TL.TrainConfig(batch_size=bsz, precision="high")
        oe = TL.make_optimizer(hc, pe)
        for _ in range(3):
            TL.train_step(pe, oe, x, hc)
        steps["high eager"] = lambda: TL.train_step(pe, oe, x, hc)
        order = [n for n, _ in tiers] + ["high eager"]
        ms = {n: [] for n in order}
        for n in order + order[::-1]:
            ms[n].append(cuda_time_ms(steps[n], iters=20))
        share = {}
        for n in ("--precision high", "high eager"):
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(10):
                    steps[n]()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            busy = busy_share(prof, wall)
            share[n] = None if busy is None else busy[0]
            if n == "high eager":
                conv_us = sum(getattr(e, "device_time_total",
                                      getattr(e, "cuda_time_total", 0))
                              for e in prof.key_averages()
                              if e.key in ("aten::convolution",
                                           "aten::convolution_backward"))
                share["conv"] = (None if busy is None else
                                 conv_us * 1e-6 / (busy[0] * wall))
        flops = step_flops(bsz, 192, False)
        b_high = 3 * flops / PEAK_BF16 * 1e3
        t = {n: sum(v) / 2 for n, v in ms.items()}
        got["high"][bsz] = {"graph": t["--precision high"],
                            "eager": t["high eager"], "bound": b_high,
                            "f32": t["f32"], "amp": t["--amp"]}

        def pct(v):
            return "not measured" if v is None else f"{v:.1%}"
        print(f"train step, batch {bsz}, crop 192, CUDA graphs in turns (CUDA "
              f"events, 2 x 20 steps): f32 {t['f32']:.3f} ms, --amp "
              f"{t['--amp']:.3f} ms, --precision high "
              f"{t['--precision high']:.3f} ms/step = "
              f"{bsz / t['--precision high'] * 1e3:.1f} samples/s (eager "
              f"{t['high eager']:.3f} ms); high: busy graph "
              f"{pct(share['--precision high'])}, eager "
              f"{pct(share['high eager'])}, convolutions "
              f"{pct(share['conv'])} of the eager step's kernel time; peak "
              f"memory f32 / --amp / high "
              f"{' / '.join(f'{peak[n] / 2**20:.1f}' for n, _ in tiers)} "
              f"MiB; high's bound {b_high:.4f} ms (3 x {flops / 1e9:.2f} "
              f"GFLOP at 989 TFLOP/s bf16); {card}")
        del steps

    tmp = tempfile.mkdtemp(prefix="chip_smoke_axes_")
    try:
        def out(name):
            return os.path.join(tmp, name)

        src = out("ti")
        os.makedirs(src)
        for i in range(4):
            imageio.save_image_u8(os.path.join(src, f"t{i}.png"),
                                  train_image(rng, 384, 512))
        anime_rsr = os.path.join(params._builtin_dir(), "anime.rsr")

        # 3. train --precision high through the CLI, validating.
        zero_counts()
        quiet(["train", out("high.rsr"), src, "-s", anime_rsr, "--precision",
               "high", "-v", src, "-m", "2", "--max_steps", "10",
               "--ckpt_every", "10", "--val_every", "10", "--metrics",
               out("high.jsonl")], "train CLI --precision high")
        n = counts()
        add(n, "xla f32")
        with open(out("high.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        size = os.path.getsize(out("high.rsr"))
        print(f"train CLI --precision high, 10 steps of batch 4 from anime, "
              f"validation at steps 1 and 10: losses "
              f"{[round(r['loss'], 6) for r in recs]}, val PSNR "
              f"{[round(r['val_psnr'], 4) for r in recs]}; .rsr {size} "
              f"bytes; epilogue launches {n['epi']}")
        if size != 1_043_676 or [r["step"] for r in recs] != [1, 10] or \
                not all(np.isfinite(r["val_psnr"]) for r in recs) or \
                n["epi"] < 1:
            fail("train --precision high: wrong files or no epilogue launch")

        # 4. The spatial and model axes: gloo ranks on cuda:0 against one
        # process on the same batches (data index 0 crops what one
        # process crops).
        api.train_folder(src, steps=10, start=anime_rsr, batch_size=4,
                         crop=192, ckpt_dir=out("oneck"), checkpoint_every=10,
                         param_file=out("one.rsr"),
                         metrics_file=out("one.jsonl"), device="cuda")
        one1, _, _ = ck.restore_native(os.path.join(out("oneck"),
                                                    "step_00000001"))
        one10 = params.load_rsr_file(out("one.rsr"), 3)
        with open(out("one.jsonl")) as f:
            one_loss = {r["step"]: r["loss"] for r in map(json.loads, f)}
        ctx = multiprocessing.get_context("spawn")
        for axes in ((1, 2, 1), (1, 1, 2), (1, 2, 2)):
            world = axes[0] * axes[1] * axes[2]
            tag = out("m%d%d%d" % axes)
            port = free_port()
            procs = [ctx.Process(target=_mesh_rank, args=(
                r, world, axes[1], axes[2], port, src, tag))
                for r in range(world)]
            t0 = time.time()
            for pr in procs:
                pr.start()
            try:
                for pr in procs:
                    pr.join(timeout=300)
            finally:
                for pr in procs:
                    if pr.is_alive():
                        pr.terminate()
                        pr.join()
            wall = time.time() - t0
            if any(pr.exitcode != 0 for pr in procs):
                fail(f"the {axes} gloo ranks exited "
                     f"{[pr.exitcode for pr in procs]}")
            ranks = [np.load(f"{tag}rank{r}.npz") for r in range(world)]
            names = [k for k in ranks[0].files if k.startswith("p_")]
            same = all(r[k].tobytes() == ranks[0][k].tobytes()
                       for r in ranks[1:] for k in names)
            with open(tag + ".jsonl") as f:
                recs = {r["step"]: r for r in map(json.loads, f)}
            ms = (recs[10]["wall_s"] - recs[1]["wall_s"]) / 9 * 1e3
            t1, opt_state, _ = ck.restore_native(os.path.join(
                tag + "ck", "step_00000001"))
            t10, opt10, _ = ck.restore_native(os.path.join(
                tag + "ck", "step_00000010"))
            ck.check_adam_state(opt10, t10)          # the unsharded layout
            rsr = params.load_rsr_file(tag + ".rsr", 3)
            l_rel = abs(recs[1]["loss"] - one_loss[1]) / one_loss[1]
            p1 = max(float(np.abs(t1[k] - one1[k]).max()) for k in one1)
            p10 = max(float(np.abs(rsr[k] - one10[k]).max()) for k in one10)
            epi = int(ranks[0]["epi"])
            print(f"mesh (data, spatial, model) = {axes}: {world} gloo ranks "
                  f"on cuda:0, train_folder batch 4, crop 192, 10 steps from "
                  f"anime: parameters of the ranks "
                  f"{'bit-identical' if same else 'DIFFERENT'} after the "
                  f"gather; against one process on the same batches: step 1 "
                  f"loss rel {l_rel:.3g} (tol 1e-5), parameters after step 1 "
                  f"max abs {p1:.3g} (tol 2e-6), rank 0's .rsr after step 10 "
                  f"{p10:.3g} (tol 1e-4, phase 4c's 10-step bound); rank 0's "
                  f"validation launched the epilogue {epi} times; "
                  f"{ms:.3f} ms/step (steps 2-10, host clock from the "
                  f"metrics; {wall:.1f} s wall with the processes' start: a "
                  f"wiring check, not scaling; {card})")
            if not (same and l_rel <= 1e-5 and p1 <= 2e-6 and p10 <= 1e-4
                    and epi >= 1):
                fail(f"the {axes} mesh disagrees with one process or "
                     "validated without the epilogue kernel")
            got["epi"]["xla f32"] += epi
            got["launches"]["epi"] += epi

        # 5. make_sharded_apply over four entries of cuda:0 as (2, 2, 1).
        mesh = M.make_mesh(2, 2, 1, devices=["cuda:0"] * 4)
        x = np.stack([synthetic_image(rng, 100, 160) for _ in range(4)]
                     ).astype(np.float32) / 255.0
        shards = M.shard_batch(mesh, x)
        sharded = M.unshard_batch(mesh, M.make_sharded_apply(mesh, 3)(
            anime, shards))
        with torch.no_grad():
            whole = sr_apply(params.to_torch(anime, dev),
                             torch.from_numpy(x).to(dev), 3).cpu()
        err = float((sharded - whole).abs().max())
        print(f"make_sharded_apply over cuda:0 x 4 as (2, 2, 1), 4 x 100x160 "
              f"LR: max abs {err:.3g} from the whole batch (tol 1e-5)")
        if not err <= 1e-5:
            fail("make_sharded_apply with a spatial axis disagrees")

        # 6. The CLI with the spatial and model axes: one card, so the
        # mesh's devices are cuda:0 listed S * M times (as phase 4d's
        # replicas); the tiles run on the data axis's one device.
        dst_dir = out("in")
        os.makedirs(dst_dir)
        for i, im in enumerate(images[:1] + images[-3:]):
            imageio.save_image_u8(os.path.join(dst_dir, f"im{i}.png"), im)
        one = os.path.join(dst_dir, "im0.png")
        real_parse = cli._parse_mesh

        def one_card(spec, device):
            a = cli._parse_mesh_spec(spec)
            return M.make_mesh(a["data"], a["spatial"], a["model"],
                               devices=[device] * (a["data"] * a["spatial"]
                                                   * a["model"]))
        cli._parse_mesh = one_card
        try:
            for spec in ("data=1,spatial=2", "data=1,model=2"):
                for what, argv, form in (
                        ("single image", ["-p", "anime", one], "xla u8"),
                        ("folder --fast", ["-p", "anime", "--fast", dst_dir],
                         "packed"),
                        ("watch --once", ["watch", "--once", "-p", "anime",
                                          dst_dir], "xla u8")):
                    tag = what.split()[0]
                    ext = ".png" if tag == "single" else ""
                    plain = out(f"{tag}_plain{ext}")
                    if not os.path.exists(plain):
                        quiet([*argv, plain], f"CLI {what}")
                    zero_counts()
                    dst = out(f"{tag}_{spec.replace(',', '_')}{ext}")
                    rest = argv[1:] if argv[0] == "watch" else argv
                    quiet(([argv[0]] if argv[0] == "watch" else [])
                          + ["--mesh", spec, *rest, dst],
                          f"CLI {what} --mesh {spec}")
                    n = counts()
                    if tag == "single":
                        pairs, same = [(plain, dst)], True
                    else:
                        names = sorted(os.listdir(plain))
                        pairs = [(os.path.join(plain, f),
                                  os.path.join(dst, f)) for f in names]
                        same = names == sorted(os.listdir(dst))
                    same = same and all(
                        imageio.load_image_u8(a).tobytes()
                        == imageio.load_image_u8(b).tobytes()
                        for a, b in pairs)
                    print(f"CLI {what} --mesh {spec} (cuda:0 listed twice): "
                          f"{'byte-identical to' if same else 'DIFFERENT from'}"
                          f" the run without it (launches: epilogue "
                          f"{n['epi']}, conv stage {n['conv']})")
                    if not same or n["epi"] < 1:
                        fail(f"CLI {what} --mesh {spec} disagrees or "
                             "launched no epilogue")
                    for stage, key in stage_shape.items():
                        if form == "packed" and stage.startswith("packed") \
                                and n["shapes"].get(key, 0) < 1:
                            fail(f"CLI {what} --mesh {spec} launched no "
                                 f"{stage} stage")
                    add(n, form)
        finally:
            cli._parse_mesh = real_parse
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return got


def variants_phase(tiling, shuffle, trunk, imageio, native, anime, lr,
                   card, zero_counts, counts):
    """Phase 4f, `tiled_sr`'s variant knobs and the int8 engine on the CLI
    image (1024x768, u8, anime, tile 242, one chunk of 24): each
    configuration through `tiled_sr` with the counts set to 0 just before
    it (the kernels of its path launched), against the same call through
    the plain versions (fast: 4 codes; exact and int8: 1; ``packed=``:
    byte-identical to the call without it) and against the exact tier
    (fast: 45 dB and 8 codes; int8: 50 dB); then each configuration's
    24-tile chunk timed by `utils.profiling.device_timer` in turns with
    the packed tier and the default flat tier, and ``torch._int_mm``
    against the plain integer product at the int8 stages' shapes
    (bit-identical; bound: the bytes, or the operations at the card's
    dense int8 peak).  Returns the launches, as phase 4d's, the chunk
    times and the int8 products' rows."""
    import contextlib
    import torch
    from rusty_sr_tpu_torch.models import quant
    from rusty_sr_tpu_torch.ops.cuda import conv_stage
    from rusty_sr_tpu_torch.utils.profiling import device_timer

    dev, bf = torch.device("cuda"), torch.bfloat16
    tile, chunk, h = 242, 24, tiling.HALO
    got = {"launches": {"f32": 0, "bf16": 0, "d2s": 0, "epi": 0, "conv": 0},
           "epi": {"xla u8": 0, "fused": 0, "xla f32": 0}, "shapes": {},
           "int8": 0}
    img = lr.astype(np.float32) / 255.0
    exact = {"u8": tiling.tiled_sr(anime, lr, 3, tile=tile, chunk=chunk,
                                   device=dev),
             "f32": tiling.tiled_sr(anime, img, 3, tile=tile, chunk=chunk,
                                    device=dev)}

    @contextlib.contextmanager
    def plain_versions():
        swaps = [(tiling, "conv_stage", conv_stage.conv_stage_reference),
                 (tiling, "epilogue_cuda", shuffle.epilogue_reference),
                 (tiling, "fused_trunk", trunk.fused_trunk_reference),
                 (quant, "conv_stage", conv_stage.conv_stage_reference),
                 (quant, "int8_mm", quant.int8_mm_reference)]
        saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
        for m, n, f in swaps:
            setattr(m, n, f)
        try:
            yield
        finally:
            for m, n, f in saved:
                setattr(m, n, f)

    def as_u8(x):
        return x.astype(np.int16) if x.dtype == np.uint8 else \
            np.floor(np.clip(x, 0, 1) * 255.0 + 0.5).astype(np.int16)

    fused_pk = {cd: trunk.pack_trunk_weights(tiling.trunk_params(anime), 3,
                                             cd)
                for cd in (torch.float32, bf)}
    # name -> (image kind, tiled_sr keywords, kernels that must launch,
    # bound vs the plain run, class vs exact: "bf16" or "int8")
    configs = {
        "flat": ("u8", dict(compute_dtype=bf, trunk="flat"),
                 ("conv", "epi"), 4, "bf16"),
        "flat conv0_s2d=False": ("u8", dict(compute_dtype=bf, trunk="flat",
                                            conv0_s2d=False),
                                 ("conv", "epi"), 4, "bf16"),
        "flat conv0_ws=False": ("u8", dict(compute_dtype=bf, trunk="flat",
                                           conv0_ws=False),
                                ("conv", "epi"), 4, "bf16"),
        "odd tile conv0_ws=False": ("u8", dict(compute_dtype=bf,
                                               tile=tile - 1, conv0_ws=False),
                                    ("conv", "epi"), 4, "bf16"),
        "flat out16=False": ("u8", dict(compute_dtype=bf, trunk="flat",
                                        out16=False),
                             ("conv", "epi"), 4, "bf16"),
        "flat out16='bcd'": ("u8", dict(compute_dtype=bf, trunk="flat",
                                        out16="bcd"),
                             ("conv", "epi"), 4, "bf16"),
        "fused packed= exact": ("f32", dict(engine="fused",
                                            packed=fused_pk[torch.float32]),
                                ("f32", "epi"), 1, None),
        "fused packed= fast": ("f32", dict(engine="fused", compute_dtype=bf,
                                           packed=fused_pk[bf]),
                               ("bf16", "epi"), 4, "bf16"),
        "int8 u8": ("u8", dict(engine="int8"), ("int8", "conv", "epi"), 1,
                    "int8"),
        "int8 f32": ("f32", dict(engine="int8"), ("int8", "conv", "epi"), 1,
                     "int8")}
    flat_s2d_shapes = {(3, 24, 128), (3, 16, 128)}
    for name, (kind, kw, must, code_bound, cls) in configs.items():
        src = lr if kind == "u8" else img
        zero_counts()
        quant.LAUNCHES = 0
        kw = {"tile": tile, "chunk": chunk, **kw}
        out = tiling.tiled_sr(anime, src, 3, device=dev, **kw)
        n = counts()
        n["int8"] = quant.LAUNCHES
        for k in must:
            if n[k] < 1:
                fail(f"variants, {name}: launched no {k} kernel")
        if kw.get("trunk") == "flat" and kw.get("conv0_s2d", True) and \
                not any(n["shapes"].get(sh, 0) for sh in flat_s2d_shapes):
            fail(f"variants, {name}: the space-to-depth conv0 stage did "
                 "not launch")
        form = ("fused" if kw.get("engine") == "fused" else
                "xla u8" if kind == "u8" else "xla f32")
        for k in got["launches"]:
            got["launches"][k] += n[k]
        got["epi"][form] += n["epi"]
        got["int8"] += n["int8"]
        for key, v in n["shapes"].items():
            got["shapes"][key] = got["shapes"].get(key, 0) + v
        with plain_versions():
            plain = tiling.tiled_sr(anime, src, 3, device=dev, **kw)
        worst = int(np.abs(as_u8(out) - as_u8(plain)).max())
        line = (f"variants, {name}: launches: conv stage {n['conv']}, "
                f"epilogue {n['epi']}, trunk f32/bf16 {n['f32']}/{n['bf16']},"
                f" torch._int_mm {n['int8']}; vs the plain versions max "
                f"{worst} u8 codes (bound {code_bound})")
        if worst > code_bound:
            fail(f"variants, {name}: {worst} codes from the plain run")
        if "packed" in kw:
            again = tiling.tiled_sr(anime, src, 3, device=dev, **{
                k: v for k, v in kw.items() if k != "packed"})
            same = again.tobytes() == out.tobytes()
            line += (f"; {'byte-identical to' if same else 'DIFFERENT from'}"
                     " the call without packed=")
            if not same:
                fail(f"variants, {name}: packed= changed the output")
        ex = exact[kind]
        db = imageio.psnr(as_u8(out) / 255.0, as_u8(ex) / 255.0)
        codes = int(np.abs(as_u8(out) - as_u8(ex)).max())
        if cls == "bf16":
            ok = db >= 45.0 and codes <= 8
            line += (f"; vs exact {db:.2f} dB, max {codes} codes (bounds 45 "
                     "dB, 8)")
        elif cls == "int8":
            ok = db >= 50.0
            line += f"; vs exact {db:.2f} dB (bound 50 dB)"
        else:
            ok = codes <= 1
            line += f"; vs the xla exact tier max {codes} codes (bound 1)"
        print(line + f" ({card})")
        if not ok or out.shape != (lr.shape[0] * 3, lr.shape[1] * 3, 3):
            fail(f"variants, {name}: outside its class against exact")

    # One chunk of each configuration, timed in turns with the packed
    # tier and the default flat tier (an odd tile).
    t1 = tile - 1
    nx2, nx1 = -(-lr.shape[1] // tile), -(-lr.shape[1] // t1)

    def chunk_of(image, tl, nx):
        ny = -(-image.shape[0] // tl)
        return tuple(torch.from_numpy(np.pad(
            t, ((0, chunk - t.shape[0]),) + ((0, 0),) * 3)).to(dev)
            for t in native.gather_tiles_range(image, tl, h, nx, 0,
                                               min(chunk, ny * nx)))
    ce, co = chunk_of(lr, tile, nx2), chunk_of(lr, t1, nx1)
    fe = chunk_of(img, tile, nx2)
    fp = tiling.prepare_stages({k: v.to(dev) for k, v in
                                tiling.flat_trunk_params(anime, True)
                                .items()})
    pp = tiling.prepare_stages({k: v.to(dev) for k, v in
                                tiling.packed_trunk_params(anime, 3).items()})
    ny2 = -(-lr.shape[0] // tile)
    q = {}
    for kind, image in (("u8", lr), ("f32", img)):
        idx = np.unique(np.linspace(0, ny2 * nx2 - 1,
                                    min(chunk, ny2 * nx2)).astype(int))
        sample = np.concatenate([native.gather_tiles_range(
            image, tile, h, nx2, i, i + 1)[0] for i in idx])
        q[kind] = tiling._int8_trunk(tiling.trunk_params(anime), sample,
                                     kind == "u8", dev)
    fpk = {cd: {k: v.to(dev) for k, v in pk.items()}
           for cd, pk in fused_pk.items()}

    def flat(tl, **kw):
        return lambda t: tiling._tile_kernel(fp, *t, 3, tl, True, True, **kw)
    timed = {   # name -> (chunk, tile kernel)
        "packed (the default fast tier)": (
            ce, lambda t: tiling._tile_kernel_packed(pp, None, t[1], t[2],
                                                       3, tile)),
        "odd tile flat (the default flat tier)": (co, flat(t1)),
        "flat": (ce, flat(tile)),
        "flat conv0_s2d=False": (ce, flat(tile, conv0_s2d=False)),
        "flat conv0_ws=False": (ce, flat(tile, conv0_ws=False)),
        "odd tile conv0_ws=False": (co, flat(t1, conv0_ws=False)),
        "flat out16=False": (ce, flat(tile, out16=False)),
        "flat out16='bcd'": (ce, flat(tile, out16="bcd")),
        "fused packed= exact": (fe, lambda t: tiling._tile_kernel_fused(
            fpk[torch.float32], *t, 3, tile, torch.float32)),
        "fused packed= fast": (fe, lambda t: tiling._tile_kernel_fused(
            fpk[bf], *t, 3, tile, bf)),
        "int8 u8": (ce, lambda t: tiling._tile_kernel_q8(
            q["u8"], *t, 3, tile, True)),
        "int8 f32": (fe, lambda t: tiling._tile_kernel_q8(
            q["f32"], *t, 3, tile, False))}
    ms = {k: [] for k in timed}
    order = list(timed)
    for name in order + order[::-1]:
        x, fn = timed[name]
        ms[name].append(device_timer(fn, x, iters=10, rounds=3,
                                     fold=lambda y, x0: x0) * 1e3)
    got["chunk_ms"] = {}
    for name in order:
        a, b = ms[name]
        got["chunk_ms"][name] = (a + b) / 2
        print(f"variants chunk, {name}, {chunk} tiles of {tile + 2 * h}^2: "
              f"{(a + b) / 2:.3f} ms "
              f"(device_timer best of 3 rounds of 10, two turns: {a:.3f} / "
              f"{b:.3f} ms; {card})")

    # torch._int_mm against the plain integer product at the int8 stages'
    # shapes: the chunk's patches (24 x 256^2 rows) of convA (K 800, N
    # 96), convB (288, 96 after padding 91) and convC (288, 64 after 59).
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    m_rows = chunk * (tile + 2 * h) ** 2
    rows = []
    for stage, k_, n_ in (("convA", 800, 96), ("convB", 288, 96),
                          ("convC", 288, 64)):
        a = torch.randint(-127, 128, (m_rows, k_), generator=gen,
                          dtype=torch.int8).to(dev)
        b = torch.randint(-127, 128, (n_, k_), generator=gen,
                          dtype=torch.int8).to(dev).t()
        kern = quant.int8_mm(a, b)
        plain = quant.int8_mm_reference(a, b)
        same = torch.equal(kern, plain)
        k_ms, p_ms, _ = time_in_turns(lambda: quant.int8_mm_reference(a, b),
                                      lambda: quant.int8_mm(a, b))
        b_ms, b_by = bound(2.0 * m_rows * k_ * n_, nbytes(a, b, kern),
                           PEAK_INT8)
        rows.append((stage, same, k_ms, p_ms, b_ms, b_by))
        print(f"torch._int_mm vs the plain integer product, {stage} "
              f"({m_rows} x {k_} x {n_}): {'bit-identical' if same else 'DIFFERENT'};"
              f" _int_mm {k_ms:.3f} ms, plain (float64, exact) {p_ms:.3f} "
              f"ms, bound {b_ms:.3f} ms ({b_by}; {b_ms / k_ms:.1%} "
              f"reached) (CUDA events, 2 x 10 calls each; {card})")
        if not same:
            fail(f"torch._int_mm differs from the plain product at {stage}")
        del a, b, kern, plain
    got["int8_mm"] = rows
    return got


def swinir_phase(card, frames: int = 4):
    """Phase 4g, SwinIR-M x4 on the batch path and its attention kernel,
    at the shapes of the benchmark's SwinIR cell (960x540 frames, padded
    to 544x960 tokens, 6 heads of 30): ``window_attn_kernel`` against
    `window_attn_reference` on the same bf16 inputs at shift 0 and 4 (2e-2
    largest, 2e-3 mean, as `tests/test_torch_swinir.py`);
    ``add_layernorm_kernel`` against `add_layernorm_reference` on the same
    tokens at C = 180 in each form the forward launches, in place and out
    of place (as `tests/test_torch_add_layernorm.py`); `upscale_batch`
    with seeded SwinIR-M weights on ``frames`` frames, fast tier, with the
    launch counts set to 0 before it (36 attention and 80 add-and-normalise
    launches a chunk, one frame a chunk by default), its first
    frame against the reference's float32 upscale within the cell's
    limits (`portbench/limits/swinir_x4_frames_fast.json`); then each
    kernel and its plain version timed in turns (attention at each
    shift), beside its bound; ``swin_mlp_kernel`` likewise against
    `swin_mlp_reference` at C = 180, hidden 360 (as
    `tests/test_torch_swin_mlp.py`), with 36 launches a chunk, and timed
    with the library's bf16 composition.  The attention also on the fast
    tier's padded rows (`swinir.row_widths`), held bit-identical to the
    call on SwinIR's own rows, and timed in turns on both, as are cuBLAS's
    qkv and proj and cuDNN's group convolution.  Returns {"launches": n,
    "err": worst max gap, "rows": [(shift, kernel ms, plain ms, bound ms,
    bound by)], "layout": [(shift, padded ms, own rows ms, padded rows
    read 4 bytes a lane ms)], "gemms": [(name, own rows ms, padded ms,
    bound ms, bound by)], "conv": (own rows ms, padded ms), "ln":
    {"launches", "err", "timed": (kernel ms, plain ms),
    "bound": (ms, by)}, "mlp": {the same, "timed": (kernel ms, plain ms,
    library ms)}}."""
    import torch
    import torch.nn.functional as F
    from portbench import images, swinir_flops
    from portbench.harness import load_json
    from portbench.reference import check
    from portbench.reference import swinir as ref
    from rusty_sr_tpu_torch.api import upscale_batch
    from rusty_sr_tpu_torch.models import swinir
    from rusty_sr_tpu_torch.ops.cuda import add_layernorm as al
    from rusty_sr_tpu_torch.ops.cuda import swin_mlp as sm
    from rusty_sr_tpu_torch.ops.cuda import window_attn as wa

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = load_json(os.path.join(root, "portbench/configs/swinir_m_x4.json"))
    limits = load_json(os.path.join(
        root, "portbench/limits/swinir_x4_frames_fast.json"))
    dev = torch.device("cuda")
    hp, wp, c = 544, 960, cfg["embed_dim"]
    heads = cfg["num_heads"][0]
    gen = torch.Generator().manual_seed(SEED)
    qkv = torch.randn(1, hp * wp, 3 * c, generator=gen).to(dev, torch.bfloat16)
    bias = wa.relative_bias(torch.randn(225, heads, generator=gen).to(dev))
    # the fast tier's rows: qkv's padded to qw (NaN in the padding here,
    # which must not reach the output), the output's to ow
    cw, qw, ow = swinir.row_widths(c, True)
    wide = F.pad(qkv, (0, qw - 3 * c), value=float("nan"))
    worst, rows = 0.0, []
    for shift in (0, 4):
        narrow = wa.window_attn(qkv, bias, shift, hp, wp)
        d = (narrow.float()
             - wa.window_attn_reference(qkv.float(), bias, shift, hp, wp)
             ).abs()
        mx, mean = float(d.max()), float(d.mean())
        padded = wa.window_attn(wide, bias, shift, hp, wp, c, ow)
        same = torch.equal(padded[..., :c], narrow)
        zeros = not bool(padded[..., c:].any())
        print(f"window_attn, {hp}x{wp} tokens, {heads} heads of "
              f"{c // heads}, shift {shift}: max {mx:.2e}, mean {mean:.2e} "
              f"against the plain version; rows of {qw} in and {ow} out "
              f"{'bit-identical' if same else 'DIFFERENT'}, padding "
              f"{'zero' if zeros else 'NOT ZERO'}")
        if mx > 2e-2 or mean > 2e-3 or not same or not zeros:
            fail(f"window_attn at shift {shift}: max {mx}, mean {mean}, "
                 f"padded rows identical {same}, padding zero {zeros}")
        worst = max(worst, mx)
        del narrow, padded, d

    # The residual stream's add-and-normalise in each form the forward
    # launches (as `tests/test_torch_add_layernorm.py::FORMS`: add + norm,
    # add + cast, the patch norm from bf16 to f32, a norm to bf16 with no
    # add), in place and out of place where it writes x_out.
    bf16, f32 = torch.bfloat16, torch.float32
    x = (torch.randn(hp * wp, c, generator=gen) * 3.0).to(dev)
    y = torch.randn(hp * wp, c, generator=gen).to(dev, bf16)
    norm = (1.0 + 0.1 * torch.randn(c, generator=gen).to(dev),
            0.1 * torch.randn(c, generator=gen).to(dev))
    ln_err = 0.0
    for has_y, has_norm, out_dtype in ((True, True, bf16),
                                       (True, False, bf16),
                                       (False, True, f32),
                                       (False, True, bf16)):
        for in_place in ((True, False) if has_y else (False,)):
            xi = x.to(bf16) if out_dtype == f32 else x
            x_k, x_p = xi.clone(), xi.clone()
            yi, ni = (y if has_y else None), (norm if has_norm else None)
            s_k, h_k = al.add_layernorm(
                x_k, yi, ni, out_dtype,
                x_k if in_place else (torch.empty_like(x_k) if has_y
                                      else None), swinir.LN_EPS)
            s_p, h_p = al.add_layernorm_reference(
                x_p, yi, ni, out_dtype, x_p if in_place else None,
                swinir.LN_EPS)
            d = (h_k.float() - h_p.float()).abs()
            if out_dtype == bf16:     # one bf16 unit (2^-20 near zero)
                tol = (torch.exp2(torch.floor(torch.log2(
                    h_p.float().abs().clamp_min(2.0 ** -126))) - 7)
                    ).clamp_min(2.0 ** -20)
            else:                     # 16 f32 units, 2^-20 besides
                tol = 16 * h_p.abs() * 2.0 ** -23 + 2.0 ** -20
            same = float((h_k == h_p).float().mean())
            err = float(d.max())
            form = (f"{'add + ' if has_y else ''}"
                    f"{'norm' if has_norm else 'cast'} to "
                    f"{'bf16' if out_dtype == bf16 else 'f32'}"
                    f"{', in place' if in_place else ''}")
            kept = not has_y or in_place or torch.equal(x_k, xi)
            print(f"add_layernorm, {hp}x{wp} tokens of {c}, {form}: sum "
                  f"{'bit-identical' if torch.equal(s_k, s_p) else 'DIFFERENT'}"
                  f", h max {err:.2e}, {same:.5%} identical to the plain "
                  f"version{'' if kept else '; x WRITTEN'}")
            if (not torch.equal(s_k, s_p) or bool((d > tol).any()) or not kept
                    or (out_dtype == bf16 and same < 0.999)):
                fail(f"add_layernorm, {form}: the sum or h differs (max "
                     f"{err}, {same:.5%} identical)")
            if out_dtype == bf16:
                ln_err = max(ln_err, err)
            del x_k, x_p, s_k, s_p, h_k, h_p, d, tol

    # The MLP on the same tokens (fc1 180 -> 360, erf GELU, fc2), weights
    # drawn as the cell draws them: every value within one bf16 unit of the
    # plain version's and 2^-6, the mean gap within 2e-5 of the mean |y|.
    hidden = c * cfg["mlp_ratio"]
    mlp = sm.prepare(
        ((torch.randn(hidden, c, generator=gen) / c ** 0.5).to(dev, bf16),
         (0.05 * torch.randn(hidden, generator=gen)).to(dev, bf16)),
        ((torch.randn(c, hidden, generator=gen) / hidden ** 0.5).to(dev, bf16),
         (0.05 * torch.randn(c, generator=gen)).to(dev, bf16)))
    hm = torch.randn(hp * wp, c, generator=gen).to(dev, bf16)
    y_k, y_p = sm.swin_mlp(hm, mlp), sm.swin_mlp_reference(hm, mlp)
    d = (y_k.float() - y_p.float()).abs()
    unit = torch.exp2(torch.floor(torch.log2(
        y_p.float().abs().clamp_min(2.0 ** -126))) - 7)
    mlp_err, mlp_mean = float(d.max()), float(d.mean())
    mlp_excess = float((d - unit).max())
    rel_mean = mlp_mean / float(y_p.float().abs().mean())
    print(f"swin_mlp, {hp}x{wp} tokens of {c}, hidden {hidden}: max "
          f"{mlp_err:.2e} ({mlp_excess:.2e} past one unit), mean "
          f"{mlp_mean:.2e} ({rel_mean:.2e} of the mean |y|), "
          f"{float((y_k == y_p).float().mean()):.5%} identical to the plain "
          "version")
    if mlp_excess > 2.0 ** -6 or rel_mean > 2e-5:
        fail(f"swin_mlp: {mlp_excess} past one unit, mean {rel_mean} of "
             "the mean |y|")
    del y_k, y_p, d, unit

    tree = ref.draw_weights(2 ** 31 + SEED, cfg)
    lr = images.pictures(2 ** 31 + SEED, "frames", frames, 540, 960,
                         device=dev).cpu().numpy()
    wa.LAUNCHES = al.LAUNCHES = sm.LAUNCHES = 0
    outs = upscale_batch(list(lr), weights=tree, factor=4, fast=True,
                         device=dev)
    torch.cuda.synchronize()
    launches, ln_launches = wa.LAUNCHES, al.LAUNCHES
    mlp_launches = sm.LAUNCHES
    # one attention launch a block for each chunk of the default size, and
    # 2 * blocks + groups + 2 add-and-normalise launches
    chunks = -(-frames // swinir.DEFAULT_CHUNK)
    want = sum(cfg["depths"]) * chunks
    if launches != want:
        fail(f"upscale_batch with SwinIR weights launched window_attn "
             f"{launches} times for {frames} frames, not {want}")
    ln_want = (2 * sum(cfg["depths"]) + len(cfg["depths"]) + 2) * chunks
    if ln_launches != ln_want:
        fail(f"upscale_batch with SwinIR weights launched add_layernorm "
             f"{ln_launches} times for {frames} frames, not {ln_want}")
    if mlp_launches != want:      # one a block, as the attention
        fail(f"upscale_batch with SwinIR weights launched swin_mlp "
             f"{mlp_launches} times for {frames} frames, not {want}")
    p = {k: v.to(dev) for k, v in tree.items()}
    gaps = check.image_gaps(outs[0], ref.upscale_u8(p, lr[0], cfg, dev))
    print(f"upscale_batch, SwinIR-M x4, {frames} 960x540 frames (fast): "
          f"{launches} window_attn, {ln_launches} add_layernorm and "
          f"{mlp_launches} swin_mlp launches; frame 0 against the reference: "
          f"{gaps} (limits {limits})")
    if (gaps["max_code_gap"] > limits["max_code_gap"]
            or gaps["mean_code_gap"] > limits["mean_code_gap"]):
        fail(f"SwinIR frame 0 is {gaps} from the reference")
    # Frame 0's bytes in each tier, to hold against another tree's on the
    # same card: the exact tier's rows are SwinIR's own in every version.
    exact = upscale_batch([lr[0]], weights=tree, factor=4, fast=False,
                          device=dev)[0]
    print(f"SwinIR-M x4 frame 0, sha256: fast {sha256(outs[0])}, exact "
          f"{sha256(exact)}")
    del p, outs, tree, exact

    tokens = hp * wp
    b_ms, b_by = bound(swinir_flops.attn_flop_per_token(cfg) * tokens,
                       swinir_flops.attn_bytes_per_token(cfg) * tokens)
    layout = []
    for shift in (0, 4):
        k_ms, p_ms, _ = time_in_turns(
            lambda: wa.window_attn_reference(qkv, bias, shift, hp, wp),
            lambda: wa.window_attn(wide, bias, shift, hp, wp, c, ow))
        rows.append((shift, k_ms, p_ms, b_ms, b_by))
        print(f"window_attn, one {hp}x{wp} frame, shift {shift}, rows of "
              f"{qw} in and {ow} out: kernel {k_ms:.3f} ms, plain "
              f"{p_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}; "
              f"{b_ms / k_ms:.1%} reached) per call (CUDA events, 2 x 10 "
              f"calls each; {card})")
        # The row layouts in turns: SwinIR's own rows, the padded rows
        # (16-byte copies), and padded input rows with an output row that
        # is no whole number of 16-byte groups (4-byte copies).
        pad_ms, own_ms, w4_ms = time_in_turns(
            lambda: wa.window_attn(qkv, bias, shift, hp, wp),
            lambda: wa.window_attn(wide, bias, shift, hp, wp, c, ow),
            lambda: wa.window_attn(wide, bias, shift, hp, wp, c, c + 6))
        layout.append((shift, pad_ms, own_ms, w4_ms))
        print(f"window_attn, one {hp}x{wp} frame, shift {shift}: rows of "
              f"{3 * c} in and {c} out {own_ms:.3f} ms, {qw} and {ow} "
              f"(16-byte copies) {pad_ms:.3f} ms, {qw} and {c + 6} (4-byte "
              f"copies) {w4_ms:.3f} ms per call (CUDA events, in turns; "
              f"{card})")
    # qkv and proj as cuBLAS runs them on SwinIR's rows and on the padded
    # rows, in turns; the bound is the published widths' bytes (h read, the
    # output written) or FLOP.
    gemms = []
    for name, n_in, n_out, w_in, w_out in (("qkv", c, 3 * c, cw, qw),
                                           ("proj", c, c, ow, ow)):
        xg = torch.randn(tokens, w_in, generator=gen).to(dev, bf16)
        xg[:, n_in:] = 0
        wg = torch.randn(w_out, w_in, generator=gen).to(dev, bf16)
        bg = torch.randn(w_out, generator=gen).to(dev, bf16)
        xn, wn, bn = xg[:, :n_in].contiguous(), \
            wg[:n_out, :n_in].contiguous(), bg[:n_out].contiguous()
        pad_ms, own_ms, _ = time_in_turns(lambda: F.linear(xn, wn, bn),
                                          lambda: F.linear(xg, wg, bg))
        g_ms, g_by = bound(2.0 * tokens * n_in * n_out,
                           2 * tokens * (n_in + n_out))
        gemms.append((name, own_ms, pad_ms, g_ms, g_by))
        print(f"{name} (F.linear, bf16), one {hp}x{wp} frame: K {n_in} N "
              f"{n_out} {own_ms:.3f} ms, K {w_in} N {w_out} {pad_ms:.3f} ms, "
              f"bound at {n_in} x {n_out} {g_ms:.3f} ms ({g_by}; "
              f"{g_ms / pad_ms:.1%} reached padded) per call (CUDA events, in "
              f"turns; {card})")
        del xg, wg, bg, xn, wn, bn
    # The group's 3x3 convolution (cuDNN, bf16, channels-last) on the plain
    # 180-wide cast and on 184-wide rows with zero weights, in turns.
    xc = torch.randn(1, cw, hp, wp, generator=gen).to(dev, bf16).contiguous(
        memory_format=torch.channels_last)
    xc[:, c:] = 0
    wc = torch.randn(c, cw, 3, 3, generator=gen).to(dev, bf16).contiguous(
        memory_format=torch.channels_last)
    wc[:, c:] = 0
    bc = torch.randn(c, generator=gen).to(dev, bf16)
    xn = xc[:, :c].contiguous(memory_format=torch.channels_last)
    wn = wc[:, :c].contiguous(memory_format=torch.channels_last)
    pad_ms, own_ms, _ = time_in_turns(
        lambda: F.conv2d(xn, wn, bc, padding=1),
        lambda: F.conv2d(xc, wc, bc, padding=1))
    conv = (own_ms, pad_ms)
    print(f"group conv (cuDNN 3x3, bf16), one {hp}x{wp} frame: {c} in "
          f"{own_ms:.3f} ms, {cw} in (zero weights) {pad_ms:.3f} ms per call "
          f"(CUDA events, in turns; {card})")
    del xc, wc, bc, xn, wn
    ln_ms, ln_plain_ms, _ = time_in_turns(
        lambda: al.add_layernorm_reference(x, y, norm, torch.bfloat16, x,
                                           swinir.LN_EPS),
        lambda: al.add_layernorm(x, y, norm, torch.bfloat16, x,
                                 swinir.LN_EPS))
    ln_b_ms, ln_b_by = bound(10.0 * tokens * c, 12 * tokens * c)
    print(f"add_layernorm, one {hp}x{wp} frame of {c}, add + norm in place: "
          f"kernel {ln_ms:.3f} ms, plain (= library: PyTorch's add, "
          f"F.layer_norm and cast) {ln_plain_ms:.3f} ms, bound {ln_b_ms:.3f} "
          f"ms ({ln_b_by}; {ln_b_ms / ln_ms:.1%} reached) per call (CUDA "
          f"events, 2 x 10 calls each; {card})")
    w1, b1 = mlp["fc1"]
    w2, b2 = mlp["fc2"]
    mlp_ms, mlp_plain_ms, mlp_lib_ms = time_in_turns(
        lambda: sm.swin_mlp_reference(hm, mlp),
        lambda: sm.swin_mlp(hm, mlp),
        lambda: F.linear(F.gelu(F.linear(hm, w1, b1)), w2, b2))
    mlp_b_ms, mlp_b_by = bound(4.0 * tokens * c * hidden, 4 * tokens * c)
    print(f"swin_mlp, one {hp}x{wp} frame of {c}, hidden {hidden}: kernel "
          f"{mlp_ms:.3f} ms, plain {mlp_plain_ms:.3f} ms, library (bf16 "
          f"F.linear, F.gelu, F.linear; timed only) {mlp_lib_ms:.3f} ms, "
          f"bound {mlp_b_ms:.3f} ms ({mlp_b_by}; {mlp_b_ms / mlp_ms:.1%} "
          f"reached) per call (CUDA events, 2 x 10 calls each; {card})")
    return {"launches": launches, "err": worst, "rows": rows,
            "layout": layout, "gemms": gemms, "conv": conv,
            "ln": {"launches": ln_launches, "err": ln_err,
                   "timed": (ln_ms, ln_plain_ms),
                   "bound": (ln_b_ms, ln_b_by)},
            "mlp": {"launches": mlp_launches, "err": mlp_err,
                    "timed": (mlp_ms, mlp_plain_ms, mlp_lib_ms),
                    "bound": (mlp_b_ms, mlp_b_by)}}


def hat_phase(card, frames: int = 2):
    """Phase 4h, HAT x4 on the batch path and its kernels, at the shapes of
    the benchmark's HAT cell (960x540 frames, padded to 544x960 tokens, 6
    heads of 30): ``hat_sa16_kernel`` at shift 0 and 8 and
    ``hat_oca_kernel`` against `hat_attn_reference` on the same bf16
    inputs (2e-2 largest, 2e-3 mean, as `tests/test_torch_hat.py`); the
    add-and-normalise's three-term form against its plain version at C =
    180 (the sum bit-identical, h within one bf16 unit); `upscale_batch`
    with seeded HAT weights on ``frames`` frames, fast tier, the launch
    counts set to 0 before it (36 window-16 attention, 6 overlapping
    attention, 42 MLP and 92 add-and-normalise launches a chunk of the
    default one frame), its first frame against the reference's float32
    upscale within the cell's limits
    (`portbench/limits/hat_x4_frames_fast.json`); then each kernel and its
    plain version timed in turns beside its bound (the attentions: their
    FLOP at 989 TFLOP/s or 1,440 bytes a token and the table at 3.35
    TB/s; the add + norm 14 C bytes a token, its plain version PyTorch's
    own adds, ``F.layer_norm`` and cast, the yardstick), with cuDNN's bf16
    ``F.conv2d`` pair of the branch (180 -> 60 -> 180, 3x3) timed beside
    them as the block's other new work.  Returns {"rows": [(name, kernel
    ms, plain ms, library ms or None, bound ms, bound by, launches, max
    err)], "launches": {...}}."""
    import torch
    import torch.nn.functional as F
    from portbench import hat_flops, images
    from portbench.harness import load_json
    from portbench.reference import check
    from portbench.reference import hat as ref
    from rusty_sr_tpu_torch.api import upscale_batch
    from rusty_sr_tpu_torch.models import hat
    from rusty_sr_tpu_torch.ops.cuda import add_layernorm as al
    from rusty_sr_tpu_torch.ops.cuda import hat_attn as ha
    from rusty_sr_tpu_torch.ops.cuda import swin_mlp as sm

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = load_json(os.path.join(root, "portbench/configs/hat_x4.json"))
    limits = load_json(os.path.join(
        root, "portbench/limits/hat_x4_frames_fast.json"))
    dev = torch.device("cuda")
    hp, wp, c = 544, 960, cfg["embed_dim"]
    heads, ws = cfg["num_heads"][0], cfg["window_size"]
    kw = hat_flops.overlap_window(cfg)
    tokens = hp * wp
    gen = torch.Generator().manual_seed(SEED)
    # qkv rows as the fast tier lays them out: 3C channels padded to 544,
    # the output's to 192 with zero columns
    qw, pw = 3 * c + (-3 * c) % 8, c + (-c) % 32
    qkv = torch.randn(1, tokens, qw, generator=gen).to(dev, torch.bfloat16)
    tabs = {k: ha.offset_table(torch.randn((ws + k - 1) ** 2, heads,
                                           generator=gen), ws, k).to(dev)
            for k in (ws, kw)}
    forms = (("hat_sa16 shift 0", ws, 0), ("hat_sa16 shift 8", ws, ws // 2),
             ("hat_oca", kw, 0))

    def attn(k, shift):
        if k == ws:
            return lambda: ha.sa_attn(qkv, tabs[k], shift, hp, wp, ws, c, pw)
        return lambda: ha.oca_attn(qkv, tabs[k], hp, wp, ws, k, c, pw)

    def plain(k, shift):
        return lambda: ha.hat_attn_reference(qkv, tabs[k], shift, hp, wp, ws,
                                             k, c, pw)
    errs = {}
    for name, k, shift in forms:
        out = attn(k, shift)()
        if out[..., c:].any():
            fail(f"{name}: the output's padding columns are not zero")
        d = (out.float() - ha.hat_attn_reference(
            qkv.float(), tabs[k], shift, hp, wp, ws, k, c, pw)).abs()
        mx, mean = float(d.max()), float(d.mean())
        errs[name] = mx
        print(f"{name}, {hp}x{wp} tokens, {heads} heads of {c // heads}: max "
              f"{mx:.2e}, mean {mean:.2e} against the plain version")
        if mx > 2e-2 or mean > 2e-3:
            fail(f"{name}: max {mx}, mean {mean}")
        del d

    # The hybrid block's add + norm: x + y + k * (z + b), then LN, to bf16.
    bf16 = torch.bfloat16
    x = (torch.randn(1, tokens, c, generator=gen) * 3.0).to(dev)
    y = torch.randn(1, tokens, c, generator=gen).to(dev, bf16)
    z = torch.randn(1, tokens, c, generator=gen).to(dev, bf16)
    k3 = (0.01 * torch.rand(1, c, generator=gen)).to(dev)
    b3 = (0.05 * torch.randn(c, generator=gen)).to(dev)
    norm = (1.0 + 0.1 * torch.randn(c, generator=gen).to(dev),
            0.1 * torch.randn(c, generator=gen).to(dev))
    s_k, h_k = al.add_layernorm(x, y, norm, bf16, None, hat.swinir.LN_EPS,
                                z, k3, b3)
    s_p, h_p = al.add_layernorm_reference(x, y, norm, bf16, None,
                                          hat.swinir.LN_EPS, z, k3, b3)
    d = (h_k.float() - h_p.float()).abs()
    unit = (torch.exp2(torch.floor(torch.log2(h_p.float().abs().clamp_min(
        2.0 ** -126))) - 7)).clamp_min(2.0 ** -20)
    same = float((h_k == h_p).float().mean())
    errs["add3"] = float(d.max())
    print(f"add_layernorm, three terms, {hp}x{wp} tokens of {c}: sum "
          f"{'bit-identical' if torch.equal(s_k, s_p) else 'DIFFERENT'}, h "
          f"max {errs['add3']:.2e}, {same:.5%} identical to the plain version")
    if not torch.equal(s_k, s_p) or bool((d > unit).any()) or same < 0.999:
        fail(f"add_layernorm, three terms: max {errs['add3']}, {same:.5%} "
             "identical")
    del s_k, s_p, h_k, h_p, d, unit

    tree = ref.draw_weights(2 ** 31 + SEED, cfg)
    lr = images.pictures(2 ** 31 + SEED, "frames", frames, 540, 960,
                         device=dev).cpu().numpy()
    ha.LAUNCHES_SA = ha.LAUNCHES_OCA = al.LAUNCHES = sm.LAUNCHES = 0
    outs = upscale_batch(list(lr), weights=tree, factor=4, fast=True,
                         device=dev)
    torch.cuda.synchronize()
    got = {"sa16": ha.LAUNCHES_SA, "oca": ha.LAUNCHES_OCA,
           "mlp": sm.LAUNCHES, "add_ln": al.LAUNCHES}
    chunks = -(-frames // hat.DEFAULT_CHUNK)
    nb, ng = hat_flops.blocks(cfg), hat_flops.groups(cfg)
    want = {"sa16": nb * chunks, "oca": ng * chunks,
            "mlp": (nb + ng) * chunks,
            "add_ln": (2 * (nb + ng) + ng + 2) * chunks}
    if got != want:
        fail(f"upscale_batch with HAT weights launched {got} for {frames} "
             f"frames, not {want}")
    p = {k_: v.to(dev) for k_, v in tree.items()}
    gaps = check.image_gaps(outs[0], ref.upscale_u8(p, lr[0], cfg, dev))
    print(f"upscale_batch, HAT x4, {frames} 960x540 frames (fast): launches "
          f"{got}; frame 0 against the reference: {gaps} (limits {limits})")
    if (gaps["max_code_gap"] > limits["max_code_gap"]
            or gaps["mean_code_gap"] > limits["mean_code_gap"]):
        fail(f"HAT frame 0 is {gaps} from the reference")
    print(f"HAT x4 frame 0 (fast), sha256: {sha256(outs[0])}")
    del p, outs, tree

    rows = []
    for name, k, shift in forms:
        k_ms, p_ms, _ = time_in_turns(plain(k, shift), attn(k, shift))
        fl = hat_flops.sa_flop_per_token(cfg) if k == ws \
            else hat_flops.oca_flop_per_token(cfg)
        b_ms, b_by = bound(fl * tokens, tokens * (
            hat_flops.attn_bytes_per_token(cfg)
            + hat_flops.table_bytes_per_token(cfg, k)))
        n = got["sa16"] if k == ws else got["oca"]
        rows.append((name, k_ms, p_ms, None, b_ms, b_by, n, errs[name]))
        print(f"{name}, one {hp}x{wp} frame: kernel {k_ms:.3f} ms, plain "
              f"{p_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}; "
              f"{b_ms / k_ms:.1%} reached) per call (CUDA events, 2 x 10 "
              f"calls each; {card})")
    a_ms, a_plain_ms, _ = time_in_turns(
        lambda: al.add_layernorm_reference(x, y, norm, bf16, x,
                                           hat.swinir.LN_EPS, z, k3, b3),
        lambda: al.add_layernorm(x, y, norm, bf16, x, hat.swinir.LN_EPS, z,
                                 k3, b3))
    a_b_ms, a_b_by = bound(12.0 * tokens * c,
                           tokens * hat_flops.add3_bytes_per_token(cfg))
    rows.append(("add_layernorm three terms", a_ms, a_plain_ms, a_plain_ms,
                 a_b_ms, a_b_by, nb * chunks, errs["add3"]))
    print(f"add_layernorm, three terms, one {hp}x{wp} frame of {c}, in place: "
          f"kernel {a_ms:.3f} ms, plain (= library: PyTorch's adds, "
          f"F.layer_norm and cast) {a_plain_ms:.3f} ms, bound {a_b_ms:.3f} ms "
          f"({a_b_by}; {a_b_ms / a_ms:.1%} reached) per call (CUDA events, 2 "
          f"x 10 calls each; {card})")
    cl = torch.channels_last
    mid = -(-c // cfg["compress_ratio"] // 8) * 8     # padded as the model
    hm = y.view(1, hp, wp, c).permute(0, 3, 1, 2)
    w0 = (torch.randn(mid, c, 3, 3, generator=gen) / (9 * c) ** 0.5).to(
        dev, bf16).contiguous(memory_format=cl)
    w2 = (torch.randn(c, mid, 3, 3, generator=gen) / (9 * mid) ** 0.5).to(
        dev, bf16).contiguous(memory_format=cl)

    b0 = torch.zeros(mid, device=dev, dtype=bf16)

    def branch():       # the model's calls: conv2's bias goes to the add
        return F.conv2d(F.gelu(F.conv2d(hm, w0, b0, padding=1)), w2,
                        padding=1)
    branch()
    cab_ms = (cuda_time_ms(branch) + cuda_time_ms(branch)) / 2
    cab_b_ms, cab_b_by = bound(hat_flops.cab_flop_per_px(cfg) * tokens,
                               tokens * c * 4)
    print(f"the branch's cuDNN bf16 conv 3x3 {c} -> {mid}, GELU, conv 3x3 "
          f"{mid} -> {c}, one {hp}x{wp} frame: {cab_ms:.3f} ms, bound "
          f"{cab_b_ms:.3f} ms ({cab_b_by}; {cab_b_ms / cab_ms:.1%} reached; "
          f"CUDA events, 2 x 10 calls; {card})")
    return {"rows": rows, "launches": got, "cab_ms": cab_ms}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rusty_sr_tpu_torch import cli, params
    from rusty_sr_tpu_torch.api import upscale
    from rusty_sr_tpu_torch.models.sr_net import sr_apply
    from rusty_sr_tpu_torch.ops.activations import belu
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
          f"{torch.cuda.get_device_name(0)}; PNG encoder and decoder: "
          f"{imageio.codec()}; {os.cpu_count()} host cores")
    if native.build_error("png"):
        print("the native PNG codec did not build, so the serving numbers "
              "below are the fallback's:\n" + native.build_error("png"))
    if not native.available():
        fail("the native tile library did not build: "
             + (native.build_error("tileio") or "no C++ compiler"))

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
    gen = torch.Generator(device="cpu").manual_seed(SEED)

    def same_bytes(got, want):
        return (got.shape == want.shape and got.dtype == want.dtype
                and torch.equal(got.contiguous().view(torch.uint8),
                                want.contiguous().view(torch.uint8)))

    # The bilinear mode's chunk: 24 tiles of 240^2, u8 (and f32 for f32
    # images) phases.
    d2s_main = torch.randint(0, 256, (24, 240, 240, 27), generator=gen,
                             dtype=torch.uint8).to(dev)
    d2s_cases = [
        ("u8, (24, 240, 240, 27)", d2s_main, 3),
        ("f32, (24, 240, 240, 27)", d2s_main.float() / 255.0, 3),
        ("f32, f=2 ragged (6, 61, 47, 12)",
         torch.randn((6, 61, 47, 12), generator=gen).to(dev), 2)]
    d2s_err = 0.0
    for name, x, f in d2s_cases:
        got = shuffle.depth_to_space_cuda(x, f)
        want = shuffle.depth_to_space_reference(x, f)
        torch.cuda.synchronize()
        same = same_bytes(got, want)
        if same:
            d2s_err = max(d2s_err, float((got.float() - want.float()).abs()
                                         .max()))
        print(f"depth-to-space kernel vs plain, {name}: "
              f"{'byte-identical' if same else 'DIFFERENT'}")
        if not same:
            fail(f"depth-to-space kernel, {name}: not byte-identical")

    # The conv-stage kernel: the packed tier's stages with their weights,
    # the flat tier's convs with theirs, and each TPU probe's own shape.
    pp = tiling.prepare_stages({k: v.to(dev) for k, v in
                                tiling.packed_trunk_params(anime, 3).items()})
    fp = tiling.prepare_stages({k: v.to(dev) for k, v in tiling
                                .flat_trunk_params(anime, fast=True).items()})

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

    p128, p255 = (24, 128, 128), (24, 255, 255)
    f32 = torch.float32
    conv_cases = [   # name, x, w, out dtype (flat: 24 tiles of 255^2, tile 241)
        ("packed W0", act(p128 + (24,), u8=True), pp["W0"], f32),
        ("packed WA", act(p128 + (128,)), pp["WA"], bf),
        ("packed WB", act(p128 + (128,)), pp["WB"], bf),
        ("packed WC", act(p128 + (128,)), pp["WC"], bf),
        ("packed WD", act(p128 + (152,)), pp["WD"], f32),
        ("flat conv0", act(p255 + (8,), u8=True), fp["conv0_u8"], f32),
        ("flat conv0 (f32 split)", act(p255 + (16,)), fp["conv0_f32"], f32),
        ("flat convA", act(p255 + (32,)), fp["convA_bf16"], bf),
        ("flat convB", act(p255 + (32,)), fp["convB_bf16"], bf),
        ("flat convC", act(p255 + (32,)), fp["convC_bf16"], bf),
        ("flat conv10", act(p255 + (32,)), fp["conv10_bf16"], bf),
        ("row 3, mosaic_probe.py: 24x136 px, 1x1, 32->96",
         act((1, 24, 136, 32)), probe_w(1, 32, 96), f32),
        ("row 4, mosaic_probe2.py: 16x128 px, 3x3, 32->96",
         act((1, 16, 128, 32)), probe_w(3, 32, 96), f32),
        ("row 5, mosaic_probe3.py: 128 x 16x128 px, 5x5, 32->96",
         act((128, 16, 128, 32)), probe_w(5, 32, 96), f32),
        ("row 6, mosaic_probe4.py: 64 x 16x256 px, 5x5, 32->96",
         act((64, 16, 256, 32)), probe_w(5, 32, 96), f32),
        ("row 7, mosaic_probe5.py: 64 x 16x256 px, 3x3, 32->96",
         act((64, 16, 256, 32)), probe_w(3, 32, 96), f32)]

    def stage_close(got, want, odt, share_of=CONV_SHARE):
        """(ok, max abs err, ulps beyond the f32 bound, share differing):
        f32 out within CONV_REL of max|want|; bf16 out within that plus
        one bf16 ulp, on at most ``share_of`` of the values."""
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        u = bf16_excess_ulps(got, want, CONV_REL * scale)
        share = float((got != want).float().mean())
        if odt == torch.float32:
            return err <= CONV_REL * scale, err, 0.0, share
        return (float(u.max()) <= 1 and share <= share_of), err, \
            float(u.max()), share

    for name, x, w, odt in conv_cases:
        got = conv_stage.conv_stage(x, w, odt)
        want = conv_stage.conv_stage_reference(x, w, odt)
        torch.cuda.synchronize()
        if got.dtype != odt or got.shape != want.shape:
            fail(f"conv stage, {name}: {got.dtype} {tuple(got.shape)}")
        if not torch.isfinite(got.float()).all():
            fail(f"conv stage, {name}: non-finite output")
        ok, err, ulps, share = stage_close(got, want, odt)
        scale = float(want.float().abs().max())
        print(f"conv stage vs plain, {name}, {str(odt)[6:]} out: max abs "
              f"err {err:.3g} = {err / scale:.3g} of max|plain|, {ulps:.3g} "
              f"ulp beyond {CONV_REL} of max|plain|, {share:.3g} of values "
              f"differ (tol: f32 {CONV_REL}; bf16 1 ulp, {CONV_SHARE})")
        if not ok:
            fail(f"conv stage, {name}: outside its bound")
    del got, want

    # The fused epilogue at the main paths' stage shapes, with the anime
    # weights and the border masks of the CLI image's first chunk:
    # byte-identical to the same kernel without it followed by the plain
    # glue, and near cuDNN plus the plain glue.
    ny, nx = -(-lr.shape[0] // 242), -(-lr.shape[1] // 242)
    pk_chunk = [None if t is None else torch.from_numpy(np.pad(
        t, ((0, 24 - t.shape[0]),) + ((0, 0),) * 3)).to(dev)
        for t in native.gather_tiles_range(lr, 242, tiling.HALO, nx, 0,
                                           ny * nx, need_zero=False)]
    ny1, nx1 = -(-lr.shape[0] // 241), -(-lr.shape[1] // 241)
    fl_chunk = [torch.from_numpy(np.pad(
        t, ((0, 24 - t.shape[0]),) + ((0, 0),) * 3)).to(dev)
        for t in native.gather_tiles_range(lr, 241, tiling.HALO, nx1, 0,
                                           min(24, ny1 * nx1))]
    m4 = tiling._pack_s2d(pk_chunk[2]).to(bf)
    m1 = fl_chunk[2].to(bf)
    Epi, Fused = conv_stage.Epilogue, conv_stage.FusedStage

    def fused_forms():
        """name -> (x, FusedStage, out dtype): each stage as the tile
        kernels call it, with random bf16 inputs and addends."""
        N, E, n, e = 128, 108, 32, 27

        def ep(tree, name, k, addends=(), mask=None, gap=0):
            return Epi(k, tree[name + "_bias"], tree[name + "_belu"],
                       addends, mask, gap=gap)
        return {
            "packed W0": (act(p128 + (24,), u8=True), Fused(
                pp["W0"], ep(pp, "f", N, (), m4)), f32),
            "packed WA": (act(p128 + (N,)), Fused(
                pp["WA"], ep(pp, "l1", N, (), m4)), bf),
            "packed WB": (act(p128 + (N,)), Fused(
                pp["WB"], ep(pp, "l2", N, (act(p128 + (384,))[..., N:],),
                             m4)), bf),
            "packed WC": (act(p128 + (N,)), Fused(
                pp["WC"], ep(pp, "l3", N, (act(p128 + (384,))[..., 2 * N:],
                                           act(p128 + (368,))[..., N:]),
                             m4, 24)), bf),
            "packed WD": (act(p128 + (264,))[..., :152], Fused(
                pp["WD"], Epi(E, pp["expand_bias"], addends=(
                    act(p128 + (368,))[..., 2 * N:],
                    act(p128 + (264,))[..., 152:]), act_dtype=f32)), f32),
            "flat conv0": (act(p255 + (8,), u8=True), Fused(
                fp["conv0_u8"], ep(fp, "f", n, (), m1)), f32),
            "flat convA": (act(p255 + (n,)), Fused(
                fp["convA_bf16"], ep(fp, "l1", n, (), m1)), bf),
            "flat convB": (act(p255 + (96,))[..., :n], Fused(
                fp["convB_bf16"], ep(fp, "l2", n, (act(p255 + (96,))[
                    ..., n:],), m1)), bf),
            "flat convC": (act(p255 + (96,))[..., :n], Fused(
                fp["convC_bf16"], ep(fp, "l3", n, (
                    act(p255 + (96,))[..., 2 * n:],
                    act(p255 + (96,))[..., n:]), m1)), bf),
            "flat conv10": (act(p255 + (64,))[..., :n], Fused(
                fp["conv10_bf16"], Epi(e, fp["expand_bias"], addends=(
                    act(p255 + (96,))[..., 2 * n:],
                    act(p255 + (64,))[..., n:]), act_dtype=f32)), bf),
            # trunk="flat" with conv0_ws=False on an even side (phase 4f)
            "s2d conv0, weights rounded once": (
                act(p128 + (16,), u8=True), Fused(fp["conv0_s2d_bf16"], Epi(
                    N, fp["f_bias4"], fp["f_belu4"], (), m4)), f32)}

    forms = fused_forms()
    fused_err = {}
    for name, (x, fs, odt) in forms.items():
        epi = fs.epilogue
        got = conv_stage.conv_stage(x, fs, odt)
        unfused = conv_stage.conv_stage(x, fs.weights, odt)
        want = conv_stage.stage_epilogue_reference(unfused, epi,
                                                   torch.empty_like(got))
        ref = conv_stage.conv_stage_reference(x, fs, odt)
        torch.cuda.synchronize()
        n, cout = epi.n_act, fs.hwio.shape[3]
        parts = [slice(0, n), slice(n + epi.gap, cout + epi.gap)]
        same = all(torch.equal(got[..., sl].contiguous().view(torch.uint8),
                               want[..., sl].contiguous().view(torch.uint8))
                   for sl in parts)
        g = torch.cat([got[..., sl].float().reshape(-1) for sl in parts])
        r = torch.cat([ref[..., sl].float().reshape(-1) for sl in parts])
        scale = float(r.abs().max())
        u = bf16_excess_ulps(g, r, CONV_REL * scale)
        err, beyond = float((g - r).abs().max()), float((u > 1).float().mean())
        fused_err[name] = err
        print(f"fused stage, {name}: "
              f"{'byte-identical to' if same else 'DIFFERENT from'} the "
              f"kernel without the epilogue + the plain glue; vs cuDNN + the "
              f"plain glue max abs err {err:.3g} ({err / scale:.3g} of max), "
              f"{beyond:.3g} of values beyond {CONV_REL} of max + 1 bf16 ulp "
              f"(tol {CONV_SHARE})")
        if not same or not torch.isfinite(g).all() or beyond > CONV_SHARE:
            fail(f"fused stage {name}: outside its bounds")
    del got, unfused, want, ref

    # The epilogue, which computes the base from the edge tiles: the xla
    # tiers' form (crop 7, the CLI image's u8 edge tiles, u8 out; f32 edge
    # tiles and out for f32 images), the fused engine's (the trunk's
    # expand at crop offset 0, f32 edge tiles), the packed tier's
    # quantise-unpack form, and ragged factor-2 cases of both.
    h = tiling.HALO

    def near_unit(shape):
        return (torch.randn(shape, generator=gen) * 0.4 + 0.5).to(dev)

    xl_chunk = [torch.from_numpy(np.pad(
        t, ((0, 24 - t.shape[0]),) + ((0, 0),) * 3)).to(dev)
        for t in native.gather_tiles_range(lr, 242, h, nx, 0, ny * nx)]
    epi_x = near_unit((24, 256, 256, 27))
    epi_packed = near_unit((24, 128, 128, 108))
    e2_u8 = torch.randint(0, 256, (6, 75, 75, 3), generator=gen,
                          dtype=torch.uint8).to(dev)
    epi_cases = {   # name -> (x, factor, tile, crop offset, kwargs)
        "xla u8": ("u8 edge tiles, crop 7, (24, 256, 256, 27) -> u8 726^2",
                   epi_x, 3, 242, h, dict(edge=xl_chunk[1], to_u8=True)),
        "xla f32": ("f32 edge tiles, crop 7, (24, 256, 256, 27) -> f32 "
                    "726^2", epi_x, 3, 242, h, dict(edge=main_e)),
        "xla f32 val": ("training's validation chunk: f32 edge tiles, crop "
                        "7, (4, 256, 256, 27) -> f32 726^2",
                        epi_x[:4].contiguous(), 3, 242, h,
                        dict(edge=main_e[:4].contiguous())),
        "fused": ("fused engine: expand (24, 242, 242, 27) + base of f32 "
                  "edge tiles -> f32 726^2", main_expand, 3, 242, 0,
                  dict(edge=main_e)),
        "packed": ("packed u8, (24, 128, 128, 108) -> 726^2", epi_packed, 3,
                   242, h, dict(to_u8=True, packed=True)),
        "xla u8 f=2": ("u8 f=2 ragged, (6, 75, 75, 12) + u8 edge tiles -> "
                       "122^2", near_unit((6, 75, 75, 12)), 2, 61, h,
                       dict(edge=e2_u8, to_u8=True)),
        "fused f=2": ("fused f=2 ragged, (6, 61, 61, 12) + f32 edge tiles -> "
                      "f32 122^2", near_unit((6, 61, 61, 12)), 2, 61, 0,
                      dict(edge=e2_u8.float() / 255.0))}
    epi_err = 0.0
    for name, x, f, tile, off, kw in epi_cases.values():
        got = shuffle.epilogue_cuda(x, f, tile, off, **kw)
        want = shuffle.epilogue_reference(x, f, tile, off, **kw)
        torch.cuda.synchronize()
        same = same_bytes(got, want)
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
        conv_stage.SHAPE_LAUNCHES.clear()

    def counts():
        torch.cuda.synchronize()
        return {"f32": trunk.LAUNCHES[torch.float32],
                "bf16": trunk.LAUNCHES[torch.bfloat16],
                "d2s": shuffle.LAUNCHES, "epi": shuffle.EPILOGUE_LAUNCHES,
                "conv": conv_stage.LAUNCHES,
                "shapes": dict(conv_stage.SHAPE_LAUNCHES)}

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
    epi_launches = {"xla u8": 0, "fused": 0, "packed": 0, "xla f32": 0}
    stage_shape = {name: (fs.hwio.shape[0], fs.hwio.shape[2],
                          fs.hwio.shape[3])
                   for name, (_, fs, _) in forms.items()}
    shape_launches = {}
    walls = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        def out(name):
            return os.path.join(tmp, name)

        src = out("lr.png")
        imageio.save_image_u8(src, lr)
        # (tier, flags, kernels that must launch, bound vs the plain run)
        runs = (("fused exact", ["--engine", "fused"], ("f32", "epi"), 1),
                ("fused fast", ["--engine", "fused", "--fast"],
                 ("bf16", "epi"), 4),
                ("xla exact", [], ("epi",), 1),
                ("xla fast", ["--fast"], ("conv", "epi"), 4),
                ("xla fast flat", ["--fast", "--tile", "241"],
                 ("conv", "epi"), 4))
        for tier, flags, must, code_bound in runs:
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
            tier_stages = {"xla fast": "packed", "xla fast flat": "flat"}
            for stage, key in stage_shape.items():
                if stage.split()[0] == tier_stages.get(tier) and \
                        n["shapes"].get(key, 0) < 1:
                    fail(f"the CLI {tier} run launched no {stage} stage")
            for k in launches:
                launches[k] += n[k]
            form = ("fused" if tier.startswith("fused") else
                    "packed" if tier == "xla fast" else "xla u8")
            epi_launches[form] += n["epi"]
            for key, v in n["shapes"].items():
                shape_launches[key] = shape_launches.get(key, 0) + v
            run_plain(argv + [out(f"{name}_plain.png")], tier)
            hk, hp = u8(out(f"{name}_kernel.png")), u8(out(f"{name}_plain.png"))
            if hk.shape != (lr.shape[0] * 3, lr.shape[1] * 3, 3):
                fail(f"CLI {tier} output has shape {hk.shape}")
            worst, count = differ(hk, hp)
            print(f"CLI {tier} PNG, kernels vs plain: max {worst} u8 codes "
                  f"({count} values differ; bound {code_bound})")
            if worst > code_bound:
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

    # 4b. Serving: folder mode, watch and tiled_sr_batch on a folder of
    # synthetic PNGs, each path with the counts set to 0 just before it.
    serve = serving_phase(cli, tiling, imageio, native, anime, rng, card,
                          zero_counts, counts, run_plain, stage_shape, walls)
    for k in launches:
        launches[k] += serve["launches"][k]
    for form, v in serve["epi"].items():
        epi_launches[form] += v
    for key, v in serve["shapes"].items():
        shape_launches[key] = shape_launches.get(key, 0) + v

    # 4c. Training: the CLI, train_folder, the card's step against the CPU
    # and float64, validation through the epilogue kernel, step times;
    # each counted run with the counts set to 0 just before it.
    trained = training_phase(cli, tiling, shuffle, params, imageio, rng,
                             card, zero_counts, counts)
    epi_launches["xla f32"] += trained["epi"]
    launches["epi"] += trained["epi"]

    # 4d. The mesh's data axis and data-parallel training on the one card;
    # each counted run with the counts set to 0 just before it.
    multi = multi_device_phase(cli, tiling, imageio, params, anime,
                               serve["images"], rng, card, zero_counts,
                               counts, stage_shape)
    for k in launches:
        launches[k] += multi["launches"][k]
    for form, v in multi["epi"].items():
        epi_launches[form] += v
    for key, v in multi["shapes"].items():
        shape_launches[key] = shape_launches.get(key, 0) + v

    # 4e. The rest of training on the one card: --precision high, the
    # mesh's spatial and model axes (gloo ranks on cuda:0), the sharded
    # whole-image net with a spatial axis, and the CLI's --mesh with the
    # spatial and model axes; each counted run with the counts set to 0
    # just before it.
    axes = mesh_axes_phase(cli, imageio, params, anime, serve["images"],
                           rng, card, zero_counts, counts, stage_shape,
                           trained["ref"])
    for k in launches:
        launches[k] += axes["launches"][k]
    for form, v in axes["epi"].items():
        epi_launches[form] += v
    for key, v in axes["shapes"].items():
        shape_launches[key] = shape_launches.get(key, 0) + v

    # 4f. tiled_sr's variant knobs and the int8 engine on the CLI image;
    # each counted run with the counts set to 0 just before it.
    variants = variants_phase(tiling, shuffle, trunk, imageio, native,
                              anime, lr, card, zero_counts, counts)
    for k in launches:
        launches[k] += variants["launches"][k]
    for form, v in variants["epi"].items():
        epi_launches[form] += v
    for key, v in variants["shapes"].items():
        shape_launches[key] = shape_launches.get(key, 0) + v

    # 4g. SwinIR through upscale_batch, and its attention kernel checked
    # and timed at the SwinIR cell's shapes.
    swin = swinir_phase(card)
    # 4h. HAT through upscale_batch, its two attention kernels and the
    # three-term add + norm checked and timed at the HAT cell's shapes.
    hat_rows = hat_phase(card)

    # 5. Times at the main path's shapes, in turns.  The trunk's work on a
    # 24 x 256^2 chunk: stage extents 252, 248, 246, 244, 242 (the halo
    # shrinks by each conv's radius); K and N per stage.  Its bound: the
    # f32 kernel runs on the FMA units (67 TFLOP/s), the bf16 kernel on the
    # tensor cores.
    ext = ((252, 5, 3, 32), (248, 5, 32, 96), (246, 3, 32, 91),
           (244, 3, 32, 59), (242, 3, 32, 27))
    trunk_flops = sum(2.0 * 24 * s_ * s_ * k_ * k_ * c_ * n_
                      for s_, k_, c_, n_ in ext)
    trunk_bytes = nbytes(main_x, main_m) + 24 * 242 * 242 * 27 * 4
    trunk_bound = {torch.float32: bound(trunk_flops, trunk_bytes, PEAK_F32),
                   torch.bfloat16: bound(trunk_flops, trunk_bytes)}
    times = {}
    for dtype, pk in ((torch.float32, packed3),
                      (torch.bfloat16, packed3_bf16)):
        times[dtype] = time_in_turns(
            lambda: trunk.fused_trunk_reference(pk, main_x, main_m, 3),
            lambda: trunk.fused_trunk(pk, main_x, main_m, 3))
        mode = "f32" if dtype == torch.float32 else "bf16"
        b_ms, b_by = trunk_bound[dtype]
        print(f"{mode} trunk, 24 x 256^2 tiles: kernel {times[dtype][0]:.3f} "
              f"ms, plain {times[dtype][1]:.3f} ms, bound {b_ms:.3f} ms "
              f"({b_by}; {b_ms / times[dtype][0]:.1%} reached) per call "
              f"(CUDA events, 2 x 10 calls each; {card})")
    # A reference figure, not the same function (so no library_ms): cuDNN's
    # five convs alone at the trunk's stage extents, in the mode's type
    # (f32 with TF32 off; bf16 channels-last), with no glue between them.
    import torch.nn.functional as F
    from rusty_sr_tpu_torch.ops.conv import exact_f32
    for dtype in (torch.float32, torch.bfloat16):
        mf = torch.channels_last if dtype == torch.bfloat16 else \
            torch.contiguous_format
        ins = [torch.randn((24, c_, s_ + k_ - 1, s_ + k_ - 1), generator=gen)
               .to(dev, dtype).contiguous(memory_format=mf)
               for s_, k_, c_, _ in ext]
        ws = [(torch.randn((n_, c_, k_, k_), generator=gen) * 0.05)
              .to(dev, dtype).contiguous(memory_format=mf)
              for _, k_, c_, n_ in ext]

        def five():
            for xi, wi in zip(ins, ws):
                F.conv2d(xi, wi)
        with exact_f32():
            five()
            five()
            ms_ = (cuda_time_ms(five) + cuda_time_ms(five)) / 2
        mode = "f32 (TF32 off)" if dtype == torch.float32 else "bf16"
        print(f"cuDNN's five trunk convs alone, {mode}, 24 x 256^2 tiles: "
              f"{ms_:.3f} ms per chunk (no glue; a reference figure, not "
              f"the fused function; CUDA events, 2 x 10 calls; {card})")
        del ins, ws
    # The shuffle kernel's forms: the bilinear mode's u8 rearrangement
    # beside the one PyTorch call for it (a strided copy), and each
    # epilogue form of the main paths.  Bound: the bytes the function must
    # move (the window of x it reads, the (tile+2)^2 edge window, the
    # output) over 3.35 TB/s.
    def d2s_library(x, f):
        n_, h_, w_, c_ = x.shape
        v = x.view(n_, h_, w_, f, f, c_ // (f * f)).permute(0, 1, 3, 2, 4, 5)
        return lambda: v.contiguous()

    times["d2s"] = time_in_turns(
        lambda: shuffle.depth_to_space_reference(d2s_main, 3),
        lambda: shuffle.depth_to_space_cuda(d2s_main, 3),
        d2s_library(d2s_main, 3))
    bounds = {"d2s": bound(0.0, 2 * nbytes(d2s_main))}
    print(f"depth-to-space, (24, 240, 240, 27) u8: kernel "
          f"{times['d2s'][0]:.3f} ms, plain {times['d2s'][1]:.3f} ms, "
          f"strided copy {times['d2s'][2]:.3f} ms, bound "
          f"{bounds['d2s'][0]:.3f} ms (bytes; "
          f"{bounds['d2s'][0] / times['d2s'][0]:.1%} reached) per call "
          f"(CUDA events, 2 x 10 calls each; {card})")
    for form in ("xla u8", "fused", "packed", "xla f32 val"):
        name, x, f, tile, off, kw = epi_cases[form]
        times[form] = time_in_turns(
            lambda: shuffle.epilogue_reference(x, f, tile, off, **kw),
            lambda: shuffle.epilogue_cuda(x, f, tile, off, **kw))
        e = kw.get("edge")
        out_b = x.shape[0] * (f * tile) ** 2 * 3 * (
            1 if kw.get("to_u8") else 4)
        moved = (x.shape[0] * tile * tile * f * f * 3 * 4 + out_b
                 + (0 if e is None else
                    x.shape[0] * (tile + 2) ** 2 * 3 * e.element_size()))
        bounds[form] = bound(0.0, moved)
        print(f"epilogue, {name}: kernel {times[form][0]:.3f} ms, plain "
              f"{times[form][1]:.3f} ms, bound {bounds[form][0]:.3f} ms "
              f"(bytes: {moved / 1e6:.1f} MB; "
              f"{bounds[form][0] / times[form][0]:.1%} reached) per call "
              f"(CUDA events, 2 x 10 calls each; {card})")
    # The conv stage at every shape: kernel, plain version (cuDNN, f32
    # with TF32 off for f32 out), cuDNN's bf16 conv (bf16 out whatever the
    # stage writes: the nearest single call) and the bound.
    for name, x, w, odt in conv_cases:
        hw = getattr(w, "hwio", w)
        k_ms, p_ms, l_ms = time_in_turns(
            lambda: conv_stage.conv_stage_reference(x, w, odt),
            lambda: conv_stage.conv_stage(x, w, odt), cudnn_bf16(x, hw))
        out_b = x.numel() // x.shape[3] * hw.shape[3] * (
            4 if odt == torch.float32 else 2)
        b_ms, b_by = bound(conv_flops(x, hw), nbytes(x, hw) + out_b)
        print(f"conv stage, {name}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} "
              f"ms, cuDNN bf16 {l_ms:.3f} ms, bound {b_ms * 1e3:.3f} µs "
              f"({b_by}; {b_ms / k_ms:.1%} reached) per call (CUDA events, "
              f"2 x 10 calls each; {card})")

    # Each fused stage as the main paths run it: the kernel with its
    # epilogue, the plain version (cuDNN + the plain glue), cuDNN's bf16
    # conv alone, and the bound (the conv's operations; the bytes of x,
    # the weights, the addends' and mask's reads and the output).
    stage_rows = {}
    for name, (x, fs, odt) in forms.items():
        epi, hw = fs.epilogue, fs.hwio
        k_ms, p_ms, l_ms = time_in_turns(
            lambda: conv_stage.conv_stage_reference(x, fs, odt),
            lambda: conv_stage.conv_stage(x, fs, odt), cudnn_bf16(x, hw))
        px = x.numel() // x.shape[3]
        out = conv_stage.conv_stage(x, fs, odt)
        moved = (nbytes(x, hw, epi.mask, epi.bias, epi.slope)
                 + px * epi.n_act * 2 * len(epi.addends)
                 + px * hw.shape[3] * out.element_size())
        b_ms, b_by = bound(conv_flops(x, hw), moved)
        stage_rows[name] = (k_ms, p_ms, l_ms, b_ms, b_by)
        print(f"fused stage, {name}: kernel {k_ms:.3f} ms, plain (cuDNN + "
              f"glue) {p_ms:.3f} ms, cuDNN bf16 conv alone {l_ms:.3f} ms, "
              f"bound {b_ms:.3f} ms ({b_by}; {b_ms / k_ms:.1%} reached) per "
              f"call (CUDA events, 2 x 10 calls each; {card})")
    del out

    # One 24-tile chunk of each fast tier: the fused stages against the
    # composition before the epilogue was fused (the same kernel's five
    # stages with the glue as plain PyTorch ops between them).
    cs_ = conv_stage.conv_stage

    def unfused_packed(edge, mask):
        ci, N, E = edge.shape[-1], 128, 108
        te8 = tiling._pack_s2d(edge).to(bf) * 2.0 ** -8
        m4_ = tiling._pack_s2d(mask).to(bf)
        t8 = te8 * m4_.repeat_interleave(ci, dim=-1)
        o = cs_(torch.cat([t8, t8], dim=-1), pp["W0"])
        mN = m4_.repeat_interleave(N // 4, dim=-1)
        f_ = belu(o + pp["f_bias"], pp["f_belu"]).to(bf) * mN
        a = cs_(f_, pp["WA"], bf)
        l1 = belu(a[..., :N].float() + pp["l1_bias"], pp["l1_belu"]).to(bf) \
            * mN
        b = cs_(l1, pp["WB"], bf)
        l2 = belu(a[..., N:2 * N].float() + b[..., :N].float()
                  + pp["l2_bias"], pp["l2_belu"]).to(bf) * mN
        c = cs_(l2, pp["WC"], bf)
        l3 = belu(a[..., 2 * N:3 * N].float() + b[..., N:2 * N].float()
                  + c[..., :N].float() + pp["l3_bias"], pp["l3_belu"]) \
            .to(bf) * mN
        d = cs_(torch.cat([l3, te8, te8], dim=-1), pp["WD"])
        total = (b[..., 2 * N:2 * N + E].float() + c[..., N:N + E].float()
                 + d + pp["expand_bias"])
        return shuffle.epilogue_cuda(total, 3, 242, h, to_u8=True,
                                     packed=True)

    def unfused_flat(z8, e8, m8):
        n, e = 32, 27
        mask = m8.float()
        t8 = z8.to(bf) * 2.0 ** -8
        c0 = cs_(torch.cat([t8, t8, torch.zeros_like(t8[..., :2])], dim=-1),
                 fp["conv0_u8"])

        def cv(t, name):
            return cs_(t.to(bf), fp[name + "_bf16"], bf).float()
        f_ = mask * belu(c0 + fp["f_bias"], fp["f_belu"])
        a = cv(f_, "convA")
        l1 = mask * belu(a[..., :n] + fp["l1_bias"], fp["l1_belu"])
        b = cv(l1, "convB")
        l2 = mask * belu(a[..., n:2 * n] + b[..., :n] + fp["l2_bias"],
                         fp["l2_belu"])
        c = cv(l2, "convC")
        l3 = mask * belu(a[..., 2 * n:3 * n] + b[..., n:2 * n] + c[..., :n]
                         + fp["l3_bias"], fp["l3_belu"])
        expand = (b[..., 2 * n:2 * n + e] + c[..., n:n + e] + cv(l3, "conv10")
                  + fp["expand_bias"])
        return shuffle.epilogue_cuda(expand.contiguous(), 3, 241, h, edge=e8,
                                     to_u8=True)

    chunks = {
        "packed": (lambda: unfused_packed(pk_chunk[1], pk_chunk[2]),
                   lambda: tiling._tile_kernel_packed(
                       pp, None, pk_chunk[1], pk_chunk[2], 3, 242)),
        "flat": (lambda: unfused_flat(*fl_chunk),
                 lambda: tiling._tile_kernel(fp, *fl_chunk, 3, 241, True,
                                             True))}
    chunk_ms = {}
    for tier, (before, fused) in chunks.items():
        if not torch.equal(before(), fused()):
            fail(f"the {tier} chunk with fused stages differs from the "
                 "composition with the plain glue")
        f_ms, b_ms, _ = time_in_turns(before, fused)
        stages = sum(v[0] for k, v in stage_rows.items()
                     if k.startswith(tier))
        chunk_ms[tier] = (f_ms, b_ms, stages)
        print(f"{tier} fast-tier chunk, 24 tiles (u8 in, u8 HR out; "
              f"byte-identical outputs): fused stages {f_ms:.3f} ms, the "
              f"stages with the plain glue between them {b_ms:.3f} ms; the "
              f"five fused stage kernels alone {stages:.3f} ms, so the rest "
              f"(input packing, epilogue kernel, the rest of the plain ops) "
              f"{f_ms - stages:.3f} ms (CUDA events, 2 x 10 calls each; "
              f"{card})")

    # One 24-tile chunk of the xla exact tier, the flat fast tier and the
    # fused exact engine as they run now (the epilogue kernel computes the
    # base from the edge tiles), and as they ran with the plain casts and
    # bilinear base, emulated: the same trunk, the plain casts and base,
    # then the epilogue kernel given the base in place of expand (the
    # earlier kernel read expand as well: one f32 tile-sized read more).
    fx = tiling.prepare_stages({k: v.to(dev) for k, v in tiling
                                .flat_trunk_params(anime, fast=False).items()})

    def plain_base_flat(z8, e8, m8, fast, tile):
        zero, mask = z8.float() * (1.0 / 255.0), m8.float()
        expand = (tiling._flat_fast_trunk(fp, zero, z8, mask) if fast
                  else tiling._flat_exact_trunk(fx, zero, mask))
        expand.contiguous()
        base = bilinear_phases_cropped(e8.float() * (1.0 / 255.0), 3, h, h,
                                       tile)
        return shuffle.epilogue_cuda(base, 3, tile, 0, to_u8=True)

    def plain_base_fused():
        trunk.fused_trunk(packed3, main_x, main_m, 3)
        base = bilinear_phases_cropped(main_e, 3, h, h, 242)
        return shuffle.epilogue_cuda(base, 3, 242, 0)

    base_chunks = {
        "xla exact": (lambda: plain_base_flat(*xl_chunk, False, 242),
                      lambda: tiling._tile_kernel(fx, *xl_chunk, 3, 242,
                                                  False, True)),
        "flat fast": (lambda: plain_base_flat(*fl_chunk, True, 241),
                      lambda: tiling._tile_kernel(fp, *fl_chunk, 3, 241,
                                                  True, True)),
        "fused exact": (plain_base_fused,
                        lambda: tiling._tile_kernel_fused(
                            packed3, main_x, main_e, main_m, 3, 242,
                            torch.float32))}
    for tier, (before, now) in base_chunks.items():
        n_ms, b_ms, _ = time_in_turns(before, now)
        print(f"{tier} chunk, 24 tiles: base in the epilogue kernel "
              f"{n_ms:.3f} ms, plain casts and base (emulated) {b_ms:.3f} "
              f"ms, {b_ms - n_ms:.3f} ms saved (CUDA events, 2 x 10 calls "
              f"each; {card})")

    for tier in ("xla exact", "xla fast", "xla fast flat", "fused exact",
                 "fused fast"):
        print(f"CLI {tier}: {walls[tier]:.3f} s wall = "
              f"{hr_mpix / walls[tier]:.2f} HR MPix/s for {lr.shape[1]}x"
              f"{lr.shape[0]} -> {lr.shape[1] * 3}x{lr.shape[0] * 3} (host "
              f"clock, first run in the process; {card})")

    def row(name, source, replaces, count, err, timed, bnd, library=None):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": count,
                "max_abs_err": err, "ms": timed[0], "plain_ms": timed[1],
                "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": library}

    trunk_src = "rusty_sr_tpu_torch/csrc/trunk.cu"
    trunk_tpu = "rusty_sr_tpu/ops/pallas/trunk.py:134"
    shuffle_src = "rusty_sr_tpu_torch/csrc/shuffle.cu"
    shuffle_tpu = "rusty_sr_tpu/ops/pallas/shuffle.py:20"
    rows = [
        row("trunk f32", trunk_src, trunk_tpu, launches["f32"],
            max_err[torch.float32], times[torch.float32],
            trunk_bound[torch.float32]),
        row("trunk bf16", trunk_src, trunk_tpu, launches["bf16"],
            max_err[torch.bfloat16], times[torch.bfloat16],
            trunk_bound[torch.bfloat16]),
        row("depth_to_space u8", shuffle_src, shuffle_tpu, launches["d2s"],
            d2s_err, times["d2s"], bounds["d2s"], times["d2s"][2])]
    for form, timed, label in (("xla u8", "xla u8", "epilogue xla u8"),
                               ("fused", "fused", "epilogue fused f32"),
                               ("packed", "packed", "epilogue packed u8"),
                               ("xla f32", "xla f32 val",
                                "epilogue xla f32")):
        rows.append(row(label, shuffle_src, shuffle_tpu, epi_launches[form],
                        epi_err, times[timed], bounds[timed]))
    for name, (k_ms, p_ms, l_ms, b_ms, b_by) in stage_rows.items():
        k = stage_shape[name][0]
        rows.append(row(
            f"conv_stage {name}", "rusty_sr_tpu_torch/csrc/conv_stage.cu",
            "scripts/mosaic_probe5.py:56" if k == 3
            else "scripts/mosaic_probe4.py:49",
            shape_launches.get(stage_shape[name], 0), fused_err[name],
            (k_ms, p_ms), (b_ms, b_by), l_ms))
    # Not a TPU kernel: SwinIR's attention (the JAX package runs none),
    # with its launches in phase 4g.
    for shift, k_ms, p_ms, b_ms, b_by in swin["rows"]:
        rows.append(row(f"window_attn shift {shift}",
                        "rusty_sr_tpu_torch/csrc/window_attn.cu",
                        "none (not a TPU kernel)",
                        swin["launches"], swin["err"], (k_ms, p_ms),
                        (b_ms, b_by)))
    ln = swin["ln"]
    rows.append(row("add_layernorm", "rusty_sr_tpu_torch/csrc/add_layernorm.cu",
                    "none (not a TPU kernel)", ln["launches"], ln["err"],
                    ln["timed"], ln["bound"], ln["timed"][1]))
    mlp = swin["mlp"]
    rows.append(row("swin_mlp", "rusty_sr_tpu_torch/csrc/swin_mlp.cu",
                    "none (not a TPU kernel)", mlp["launches"], mlp["err"],
                    mlp["timed"], mlp["bound"], mlp["timed"][2]))
    # Not TPU kernels: HAT's attentions and its three-term add + norm (the
    # JAX package runs no transformer), with their launches in phase 4h.
    for name, k_ms, p_ms, l_ms, b_ms, b_by, n, err in hat_rows["rows"]:
        src = ("rusty_sr_tpu_torch/csrc/add_layernorm.cu" if "add" in name
               else "rusty_sr_tpu_torch/csrc/hat_attn.cu")
        rows.append(row(name, src, "none (not a TPU kernel)", n, err,
                        (k_ms, p_ms), (b_ms, b_by), l_ms))
    # Not a TPU kernel: the int8 engine's products (the JAX package's XLA
    # dot_general) on torch._int_mm, with their launches in phase 4f.
    print(json.dumps({"int8_products": [
        {"name": f"torch._int_mm {stage}", "replaces":
         "rusty_sr_tpu/models/quant.py:158", "launches": variants["int8"],
         "bit_identical": same, "ms": k_ms, "plain_ms": p_ms,
         "bound_ms": b_ms, "bound_by": b_by}
        for stage, same, k_ms, p_ms, b_ms, b_by in variants["int8_mm"]]}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
