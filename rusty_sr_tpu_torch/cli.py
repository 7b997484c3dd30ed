"""Command-line interface: single-image upscale.

The flags keep the names of `rusty_sr_tpu/cli.py`.  The paths ported so
far are both engines — xla (the default: u8 tiles in, u8 HR tiles out)
and fused — in the exact (f32) tier and, with ``--fast``, the bf16 tier,
and the ``-p bilinear`` and ``-d`` modes: the kernels on the card
(``--platform gpu``, the default) or their plain PyTorch versions on the
CPU (``--platform cpu``).  Flags and modes whose paths are not ported yet
exit with code 2.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

_NOT_PORTED = "is not ported yet to the PyTorch package (rusty-sr runs it)"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rusty-sr-torch",
        description="A convolutional neural network trained to upscale "
                    "images (PyTorch and CUDA).")
    p.add_argument("--version", action="version",
                   version="rusty_sr_tpu_torch v0.1.0")
    p.add_argument("INPUT_FILE", help="input image to upscale")
    p.add_argument("OUTPUT_FILE",
                   help="output file to write/overwrite (.png recommended)")
    p.add_argument("-p", "--parameters",
                   choices=["imagenet", "imagenetlinear", "anime", "bilinear"],
                   help="which built-in parameters to use with the neural net")
    p.add_argument("-c", "--custom", metavar="PARAMETER_FILE",
                   help="custom parameter file (.rsr) to use with the "
                        "neural net")
    p.add_argument("-d", "--downsample", action="store_true",
                   help="perform downscaling rather than upscaling")
    p.add_argument("-f", "--factor", type=int, default=3,
                   help="upscale factor (custom weights must match)")
    p.add_argument("--tile", type=int, default=242,
                   help="LR tile size for overlap-tile inference")
    p.add_argument("--chunk", type=int, default=None,
                   help="tiles per device dispatch (default 24)")
    p.add_argument("--fast", action="store_true",
                   help="the fast tier: the trunk in bf16 with f32 "
                        "accumulation instead of exact f32 (at least 45 dB "
                        "and at most 8 u8 codes from the exact tier)")
    p.add_argument("--engine", choices=["xla", "fused"], default="xla",
                   help="device engine: 'xla' (default), the trunk as conv "
                        "stages with u8 tiles in and out; 'fused', the "
                        "trunk as one CUDA kernel")
    p.add_argument("--mesh", metavar="SPEC", default=None,
                   help="shard tiles over several devices (not ported yet)")
    p.add_argument("--platform", choices=["gpu", "cpu"], default="gpu",
                   help="'gpu' (default; needs CUDA) or 'cpu' (the "
                        "kernels' plain PyTorch versions)")
    return p


def _not_ported(args):
    """The first flag or mode the port cannot run yet, or None."""
    if args.mesh:
        return "--mesh"
    if os.path.isdir(args.INPUT_FILE):
        return "a folder input"
    return None


def _fast_tier_tip(args) -> None:
    """One stderr line pointing exact-tier users of the default engine at
    ``--fast``."""
    if not args.fast and args.engine == "xla":
        print("tip: running the exact tier; --fast runs the bf16 tier, "
              "within 8 u8 codes and at least 45 dB of it", file=sys.stderr)


def device_for(platform: str):
    """The torch device for ``--platform``; raises when 'gpu' finds no CUDA
    device (the CPU is used only when asked for)."""
    import torch
    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("--platform gpu needs a CUDA device and none is "
                           "available; pass --platform cpu to run on the CPU")
    return torch.device("cuda")


def _run_simple(args, img_u8, device) -> int:
    """The non-neural modes, ``-d`` and ``-p bilinear``."""
    from rusty_sr_tpu_torch.parallel.tiling import tiled_simple
    from rusty_sr_tpu_torch.utils.imageio import save_image_u8

    if args.downsample:
        print("Downsampling using average pooling of linear RGB values...",
              end="", flush=True)
        f = args.factor
        h, w, _ = img_u8.shape
        out = tiled_simple(img_u8[: h - h % f, : w - w % f], f,
                           mode="downsample", device=device)
    else:
        print("Upscaling using bilinear interpolation...", end="",
              flush=True)
        out = tiled_simple(img_u8, args.factor, mode="bilinear",
                           device=device)
    print(" Writing file...", end="", flush=True)
    try:
        save_image_u8(args.OUTPUT_FILE, out)
    except OSError as e:
        print(f"\nCould not write output file: {e}", file=sys.stderr)
        return 1
    print(" Done")
    return 0


def run_upscale(args) -> int:
    import torch
    from rusty_sr_tpu_torch import params as params_lib
    from rusty_sr_tpu_torch.parallel.tiling import tiled_sr
    from rusty_sr_tpu_torch.utils.imageio import (
        DECODE_ERRORS, check_codec, load_image_u8, save_image, save_image_u8)

    if args.custom and args.parameters:
        print("error: --custom conflicts with --parameters", file=sys.stderr)
        return 2
    if args.downsample and (args.custom or args.parameters):
        print("error: --downsample conflicts with --parameters/--custom",
              file=sys.stderr)
        return 2
    missing = _not_ported(args)
    if missing:
        print(f"error: {missing} {_NOT_PORTED}", file=sys.stderr)
        return 2
    device = device_for(args.platform)
    try:
        check_codec(args.INPUT_FILE)
        check_codec(args.OUTPUT_FILE)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    try:
        img_u8 = load_image_u8(args.INPUT_FILE)
    except DECODE_ERRORS as e:
        print(f"Error opening input image file: {e}", file=sys.stderr)
        return 1
    if args.downsample or args.parameters == "bilinear":
        return _run_simple(args, img_u8, device)

    _fast_tier_tip(args)
    if args.custom:
        print("Upscaling using custom neural net parameters...", end="",
              flush=True)
        src = args.custom
        loader = lambda: params_lib.load_rsr_file(args.custom, args.factor)  # noqa: E731
    else:
        name = args.parameters or "imagenet"
        label = {"imagenet": "imagenet",
                 "imagenetlinear": "linear loss imagenet",
                 "anime": "anime"}[name]
        print(f"Upscaling using {label} neural net parameters...", end="",
              flush=True)
        src = f"builtin '{name}'"
        loader = lambda: params_lib.load_builtin(name, args.factor)  # noqa: E731
    try:
        tree = loader()
    except OSError as e:
        print(f"\nError opening parameter file: {e}", file=sys.stderr)
        return 1
    except ValueError as e:
        print(f"\nerror: {e} ({src}). Parameters selected do not have the "
              "size required by the neural net. Ensure that the same factor "
              "is used for upscaling and training.", file=sys.stderr)
        return 1

    # The xla engine takes the u8 pixels as they are and returns u8 HR
    # pixels; the fused engine runs on f32 in [0, 1].
    img = img_u8 if args.engine == "xla" else \
        img_u8.astype(np.float32) / 255.0
    out = tiled_sr(tree, img, args.factor, tile=args.tile, chunk=args.chunk,
                   engine=args.engine, device=device,
                   compute_dtype=torch.bfloat16 if args.fast else None)
    print(" Writing file...", end="", flush=True)
    try:
        if out.dtype == np.uint8:
            save_image_u8(args.OUTPUT_FILE, out)
        else:
            save_image(args.OUTPUT_FILE, out)
    except OSError as e:
        print(f"\nCould not write output file: {e}", file=sys.stderr)
        return 1
    print(" Done")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("train", "watch"):
        print(f"error: the {argv[0]} command {_NOT_PORTED}", file=sys.stderr)
        return 2
    return run_upscale(build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
