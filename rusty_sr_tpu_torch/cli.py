"""Command-line interface: single-image and folder upscale, and watch.

The flags keep the names of `rusty_sr_tpu/cli.py`, and the paths are its
paths: both engines — xla (the default: u8 tiles in, u8 HR tiles out)
and fused — in the exact (f32) tier and, with ``--fast``, the bf16 tier
(the int8 engine is the API's alone, as there);
the ``-p bilinear`` and ``-d`` modes; a folder as the input (every image
in it upscaled into the output folder, tiles batched across images on
the xla engine); ``watch``, the resident serving mode; and ``train``,
which fits new parameters to an image folder.  Each runs on the card
(``--platform gpu``, the default) or on the CPU (``--platform cpu``: the
kernels' plain PyTorch versions).  Every upscale and downscale goes
through `api` (`upscale`, `upscale_batch`, `upscale_bilinear`,
`downscale`); the CLI owns its flags, codecs, messages and exit codes.

``--mesh data=N[,spatial=S][,model=M]`` (or ``N``) runs the JAX
package's mesh (`parallel.mesh`): upscale (xla engine), folder and
``watch`` split each chunk of tiles over the N devices of the data axis
(a mesh of N*S*M devices; each chunk's tiles run once, on one device per
data index, where JAX replicates them over the other axes with the same
result; a single bilinear or downsample image ignores the mesh, as in
JAX, and says so), and ``train`` trains on N*S*M local processes, one
per device, over `torch.distributed`: the batch split over the data
axis, each crop's rows over the spatial axis, the parameters and Adam's
state sharded over the model axis.  ``train --coordinator HOST:PORT
--num_processes P --process_id I`` makes this process rank I of P (NCCL
on the card, gloo on the CPU; P must equal N*S*M when ``--mesh`` is
given).  ``train --precision high`` runs the f32 tiers' convolutions as
the three-term bf16 split, the JAX package's ``Precision.HIGH``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

import numpy as np

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rusty-sr-torch",
        description="A convolutional neural network trained to upscale "
                    "images (PyTorch and CUDA). Run the `watch` subcommand "
                    "to serve a folder.")
    p.add_argument("--version", action="version",
                   version="rusty_sr_tpu_torch v0.1.0")
    p.add_argument("INPUT_FILE",
                   help="input image to upscale, or a folder of images "
                        "(tiles are then batched across images)")
    p.add_argument("OUTPUT_FILE",
                   help="output file to write/overwrite (.png recommended); "
                        "a folder when INPUT_FILE is a folder")
    p.add_argument("-p", "--parameters",
                   choices=["imagenet", "imagenetlinear", "anime", "bilinear"],
                   help="which built-in parameters to use with the neural net")
    p.add_argument("-c", "--custom", metavar="PARAMETER_FILE",
                   help="custom parameter file to use with the neural net: "
                        "a .rsr file, or a SwinIR or HAT checkpoint (.pth, "
                        "whose "
                        "own scale sets the factor)")
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
                        "trunk as one CUDA kernel (single images only)")
    p.add_argument("--mesh", metavar="SPEC", default=None,
                   help="device mesh: 'data=N[,spatial=M][,model=K]' or "
                        "just 'N'; each chunk of tiles is split over the N "
                        "devices of the data axis (xla engine; on "
                        "--platform cpu, entries of the CPU)")
    p.add_argument("--platform", choices=["gpu", "cpu"], default="gpu",
                   help="'gpu' (default; needs CUDA) or 'cpu' (the "
                        "kernels' plain PyTorch versions)")
    p.add_argument("--trace", metavar="DIR", default=None,
                   help="record a torch.profiler trace of the run to "
                        "DIR/trace.json (Chrome trace format)")
    return p


def build_watch_parser() -> argparse.ArgumentParser:
    w = argparse.ArgumentParser(
        prog="rusty-sr-torch watch",
        description="Serving mode: watch a folder and upscale every image "
                    "that appears in it. The process stays resident, so "
                    "the weights and built kernels are loaded once, and "
                    "new arrivals are batched across images.")
    w.add_argument("INPUT_DIR", help="folder to watch for images")
    w.add_argument("OUTPUT_DIR", help="upscaled images are written here")
    w.add_argument("-p", "--parameters",
                   choices=["imagenet", "imagenetlinear", "anime"],
                   help="which built-in parameters to use")
    w.add_argument("-c", "--custom", metavar="PARAMETER_FILE",
                   help="custom parameter file (.rsr, or a SwinIR or HAT "
                        ".pth)")
    w.add_argument("-f", "--factor", type=int, default=3)
    w.add_argument("--fast", action="store_true",
                   help="the fast tier (bf16 trunk), as for single images")
    w.add_argument("--tile", type=int, default=242)
    w.add_argument("--chunk", type=int, default=None)
    w.add_argument("--poll", type=float, default=1.0,
                   help="seconds between folder scans")
    w.add_argument("--once", action="store_true",
                   help="process the current folder contents and exit")
    w.add_argument("--mesh", metavar="SPEC", default=None,
                   help="device mesh: 'data=N[,spatial=M][,model=K]' or "
                        "just 'N'; each chunk of tiles is split over the N "
                        "devices of the data axis")
    w.add_argument("--metrics", metavar="FILE", default=None,
                   help="append one JSONL record per processed group "
                        "(images, failures, HR MPix, latency, MPix/s)")
    w.add_argument("--trace", metavar="DIR", default=None,
                   help="record a torch.profiler trace of the run to "
                        "DIR/trace.json (pair with --once)")
    w.add_argument("--platform", choices=["gpu", "cpu"], default="gpu",
                   help="'gpu' (default; needs CUDA) or 'cpu'")
    return w


def build_train_parser() -> argparse.ArgumentParser:
    t = argparse.ArgumentParser(
        prog="rusty-sr-torch train",
        description="Train a new set of neural parameters on your own dataset")
    t.add_argument("PARAMETER_FILE",
                   help="learned parameters are (over)written to this .rsr "
                        "file")
    t.add_argument("TRAINING_FOLDER",
                   help="images from this folder are used for training")
    t.add_argument("-l", "--linearLoss", action="store_true",
                   dest="linear_loss",
                   help="apply MSE loss to linearised RGB output rather "
                        "than sRGB values")
    t.add_argument("-r", "--recurse", action="store_true",
                   help="recurse into subfolders looking for files")
    t.add_argument("-s", "--start", metavar="FILE",
                   help="start training from parameters in this .rsr file")
    t.add_argument("-v", "--val_folder", metavar="DIR",
                   help="images from this folder are used to evaluate "
                        "training progress")
    t.add_argument("-m", "--val_max", type=int, metavar="N",
                   help="upper limit on number of images per validation pass")
    t.add_argument("-f", "--factor", type=int, default=3)
    t.add_argument("--loss", choices=["mse", "l1"], default="mse",
                   help="data loss (the reference uses MSE)")
    t.add_argument("--max_steps", type=int, default=None,
                   help="optional hard step cap (for smoke runs)")
    t.add_argument("--metrics", metavar="FILE", default=None,
                   help="append JSONL training metrics to FILE")
    t.add_argument("--ckpt_dir", metavar="DIR", default=None,
                   help="also write resumable checkpoints (parameters, "
                        "optimizer state, step) to DIR")
    t.add_argument("--resume", metavar="DIR", nargs="?", const="",
                   default=None,
                   help="resume from the latest checkpoint in DIR (default: "
                        "--ckpt_dir), restoring parameters, optimizer state "
                        "and the step counter — unlike -s/--start, which "
                        "loads bare parameters only")
    t.add_argument("--mesh", metavar="SPEC", default=None,
                   help="'data=N[,spatial=M][,model=K]' or 'N': the batch "
                        "split over N, each crop's rows over M, the "
                        "parameters and optimizer state sharded over K. "
                        "Without --coordinator, starts N*M*K local "
                        "processes (ranks over 127.0.0.1, one device each: "
                        "cuda:I mod the device count, or the CPU); with "
                        "it, N*M*K must equal --num_processes")
    t.add_argument("--amp", action="store_true",
                   help="mixed-precision training: bf16 convolution "
                        "operands with f32 sums, f32 parameters and "
                        "optimizer state")
    t.add_argument("--trunk", choices=["merged", "flat", "packed"],
                   default="merged",
                   help="the step's forward form: 'merged' (wide convA/B/C, "
                        "the default), 'flat' (the reference's topology), "
                        "'packed' (the bf16 2x2 space-to-depth trunk)")
    t.add_argument("--precision", choices=["highest", "high"],
                   default="highest",
                   help="f32 convolution precision: 'highest' (exact, "
                        "the default) or 'high' (each product as three "
                        "bf16 products, hi*hi + hi*lo + lo*hi, summed in "
                        "f32); ignored with --amp and --trunk packed")
    t.add_argument("--crop", type=int, default=None, metavar="N",
                   help="HR training crop side (default 192). Must be "
                        "divisible by the factor, and give an even LR crop "
                        "for --trunk packed")
    t.add_argument("--remat", action="store_true",
                   help="recompute the forward in the backward pass: less "
                        "device memory for more operations")
    t.add_argument("--batch", type=int, default=None,
                   help="batch size (the reference's default is 4)")
    t.add_argument("--ckpt_every", type=int, default=None, metavar="N",
                   help="checkpoint cadence in steps (default 100; step 1 "
                        "always checkpoints)")
    t.add_argument("--val_every", type=int, default=None, metavar="N",
                   help="validation cadence in steps (default 100; "
                        "independent of --ckpt_every)")
    t.add_argument("--steps_per_dispatch", type=int, default=None,
                   metavar="N",
                   help="batches uploaded to the device at once (default "
                        "10; clamped to divide the checkpoint and "
                        "validation cadences)")
    t.add_argument("--data_workers", type=int, default=None, metavar="N",
                   help="host decode/crop worker threads (default: CPU "
                        "count, capped at 16); the batches are the same "
                        "for any N")
    t.add_argument("--coordinator", metavar="HOST:PORT", default=None,
                   help="multi-process training: the address of rank 0's "
                        "rendezvous (torch.distributed, tcp://HOST:PORT)")
    t.add_argument("--num_processes", type=int, default=None,
                   help="multi-process training: the number of processes, "
                        "one device each")
    t.add_argument("--process_id", type=int, default=None,
                   help="multi-process training: this process's rank "
                        "(0-based; rank 0 prints, validates and writes the "
                        "checkpoints; device cuda:I mod the device count, "
                        "NCCL; gloo on --platform cpu)")
    t.add_argument("--platform", choices=["gpu", "cpu"], default="gpu",
                   help="'gpu' (default; needs CUDA) or 'cpu'")
    t.add_argument("--trace", metavar="DIR", default=None,
                   help="record a torch.profiler trace of the run to "
                        "DIR/trace.json")
    return t


def _parse_mesh_spec(spec_str: str) -> dict:
    """'data=N[,spatial=M][,model=K]' or 'N' -> {'data': N, 'spatial': M,
    'model': K} (raises ValueError)."""
    spec = dict(kv.split("=", 1) for kv in spec_str.split(",")) \
        if "=" in spec_str else {"data": spec_str}
    if "data" not in spec:
        raise ValueError("mesh spec needs a 'data' axis")
    axes = {k: int(spec.pop(k, 1)) for k in ("data", "spatial", "model")}
    if spec:
        raise ValueError(f"unknown mesh axes {sorted(spec)}")
    if min(axes.values()) < 1:
        raise ValueError("every mesh axis must be >= 1")
    return axes


def _parse_mesh(spec_str: str, device):
    """A --mesh spec -> `parallel.mesh.Mesh` of the ``device``'s kind: N
    entries of the CPU, or N of the visible CUDA devices (raises
    ValueError)."""
    import torch
    from rusty_sr_tpu_torch.parallel.mesh import make_mesh
    axes = _parse_mesh_spec(spec_str)
    device = torch.device(device)
    devices = [device] * (axes["data"] * axes["spatial"] * axes["model"]) \
        if device.type == "cpu" else None
    return make_mesh(axes["data"], axes["spatial"], axes["model"],
                     devices=devices)


def _refused(args) -> Optional[int]:
    """Exit code 2, after saying why, for a malformed ``--mesh`` spec;
    None otherwise."""
    if args.mesh:
        try:
            _parse_mesh_spec(args.mesh)
        except ValueError as e:
            print(f"error: bad --mesh {args.mesh!r}: {e}", file=sys.stderr)
            return 2
    return None


def _mesh_arg(args, device):
    """(mesh or None, None) for ``--mesh``, or (None, 2) after printing
    why the devices cannot hold it."""
    if not args.mesh:
        return None, None
    try:
        return _parse_mesh(args.mesh, device), None
    except ValueError as e:
        print(f"error: bad --mesh {args.mesh!r}: {e}", file=sys.stderr)
        return None, 2


def _fast_tier_tip(args) -> None:
    """One stderr line pointing exact-tier users of the default engine at
    ``--fast``."""
    if not args.fast and getattr(args, "engine", "xla") == "xla":
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


def _simple(args, img_u8, device) -> np.ndarray:
    """``-d`` or ``-p bilinear`` on one image."""
    from rusty_sr_tpu_torch import api
    if args.downsample:
        return api.downscale(img_u8, args.factor, device=device)
    return api.upscale_bilinear(img_u8, args.factor, device=device)


def _run_simple(args, img_u8, device) -> int:
    """The non-neural modes, ``-d`` and ``-p bilinear``."""
    from rusty_sr_tpu_torch.utils.imageio import save_image_u8

    if args.downsample:
        print("Downsampling using average pooling of linear RGB values...",
              end="", flush=True)
    else:
        print("Upscaling using bilinear interpolation...", end="",
              flush=True)
    out = _simple(args, img_u8, device)
    print(" Writing file...", end="", flush=True)
    try:
        save_image_u8(args.OUTPUT_FILE, out)
    except OSError as e:
        print(f"\nCould not write output file: {e}", file=sys.stderr)
        return 1
    print(" Done")
    return 0


def _load_weights(args):
    """The parameter tree of ``-c`` or ``-p`` (imagenet by default), or
    the exit code after printing why it cannot be loaded.  A SwinIR or
    HAT checkpoint sets ``args.factor`` to its own scale."""
    from rusty_sr_tpu_torch import params as params_lib
    try:
        if args.custom:
            tree = params_lib.load_weights_file(args.custom, args.factor)
            if params_lib.is_checkpoint_path(args.custom):
                args.factor = params_lib.weights_factor(tree)
            return tree
        return params_lib.load_builtin(args.parameters or "imagenet",
                                       args.factor)
    except OSError as e:
        print(f"\nError opening parameter file: {e}", file=sys.stderr)
        return 1
    except ValueError as e:
        src = args.custom or f"builtin '{args.parameters or 'imagenet'}'"
        print(f"\nerror: {e} ({src}). Parameters selected do not have the "
              "size required by the neural net. Ensure that the same factor "
              "is used for upscaling and training.", file=sys.stderr)
        return 1


def run_upscale(args) -> int:
    from rusty_sr_tpu_torch import api
    from rusty_sr_tpu_torch.models import whole_frame_model
    from rusty_sr_tpu_torch.params import is_checkpoint_path
    from rusty_sr_tpu_torch.utils.imageio import (
        DECODE_ERRORS, check_codec, load_image_u8, save_image, save_image_u8)

    if args.custom and args.parameters:
        print("error: --custom conflicts with --parameters", file=sys.stderr)
        return 2
    if args.downsample and (args.custom or args.parameters):
        print("error: --downsample conflicts with --parameters/--custom",
              file=sys.stderr)
        return 2
    simple = args.downsample or args.parameters == "bilinear"
    folder = os.path.isdir(args.INPUT_FILE)
    if args.mesh and simple and not folder:
        # The JAX CLI takes a single image's simple path before it reads
        # --mesh: the image runs on one device, whatever the spec.
        print(f"note: --mesh {args.mesh} is not used: a single bilinear or "
              "downsample image runs on one device", file=sys.stderr)
        args.mesh = None
    refused = _refused(args)
    if refused is not None:
        return refused
    if args.mesh and simple:
        # A silent single-device run would hand a user who asked for N
        # devices one.
        print("error: --mesh is not supported for the bilinear/downsample "
              "folder paths", file=sys.stderr)
        return 2
    if args.mesh and args.engine != "xla":
        print(f"error: --mesh supports the 'xla' engine only (got "
              f"{args.engine!r})", file=sys.stderr)
        return 2
    device = device_for(args.platform)
    mesh, rc = _mesh_arg(args, device)
    if rc is not None:
        return rc
    if folder:
        return _run_upscale_folder(args, device, mesh)
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
    if simple:
        return _run_simple(args, img_u8, device)

    _fast_tier_tip(args)
    label = "custom" if args.custom else {
        "imagenet": "imagenet", "imagenetlinear": "linear loss imagenet",
        "anime": "anime"}[args.parameters or "imagenet"]
    print(f"Upscaling using {label} neural net parameters...", end="",
          flush=True)
    tree = _load_weights(args)
    if isinstance(tree, int):
        return tree
    kw = dict(fast=args.fast, tile=args.tile, chunk=args.chunk,
              device=device)
    try:
        if mesh is None:
            out = api.upscale(img_u8, tree, args.factor, engine=args.engine,
                              **kw)
        else:
            out = api.upscale_batch([img_u8], tree, args.factor, mesh=mesh,
                                    **kw)[0]
    except ValueError:
        # The one refusal that a checkpoint's weights (SwinIR, HAT) add: an
        # engine other than xla.
        if args.engine == "xla" or not is_checkpoint_path(args.custom or ""):
            raise
        print(f"\nerror: {whole_frame_model(tree).NAME} weights run on "
              "--engine xla only", file=sys.stderr)
        return 2
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


# --- Serving: folders and watch ---

class _StableNamer:
    """Output name per source path, stable for the namer's lifetime.

    The first source to claim a stem keeps ``stem.png``; a later source
    with the same stem ('a.png' then 'a.jpg', in one batch or in two
    polls of the watcher) keeps its whole name ('a.jpg.png'), and where
    that is taken too, a counter ('a.jpg.2.png'), so no two sources ever
    write one file."""

    def __init__(self):
        self._owner: dict = {}   # output name -> source path

    def __call__(self, f: str) -> str:
        stem = os.path.splitext(os.path.basename(f))[0] + ".png"
        if self._owner.setdefault(stem, f) == f:
            return stem
        cand = os.path.basename(f) + ".png"
        k = 1
        while self._owner.setdefault(cand, f) != f:
            k += 1
            cand = f"{os.path.basename(f)}.{k}.png"
        return cand


def _output_names(paths) -> list:
    """Output file names for a batch of input paths (`_StableNamer`)."""
    namer = _StableNamer()
    return [namer(f) for f in paths]


class _AsyncWriter:
    """Write-behind PNG encoding for the folder and watch modes.

    Each finished image is encoded on a worker thread (the native encoder
    and Pillow release the interpreter lock) while the card computes
    later chunks; at most ``2 * workers + 2`` writes wait, and `submit`
    blocks beyond that, which holds the chunk loop back.  `finish` joins
    the writes and returns their failures instead of raising mid-batch.
    """

    def __init__(self, workers: Optional[int] = None):
        import concurrent.futures
        import threading
        if workers is None:
            workers = max(1, min(8, os.cpu_count() or 2))
        self._sem = threading.Semaphore(2 * workers + 2)
        self._ex = concurrent.futures.ThreadPoolExecutor(workers)
        self._futs: list = []   # (path, future)

    def submit(self, path: str, img) -> None:
        from rusty_sr_tpu_torch.utils.imageio import save_image_u8
        self._sem.acquire()

        def job():
            try:
                # One image a thread already fills the cores: no deflate
                # threads within an image.
                save_image_u8(path, img, png_threads=1)
            finally:
                self._sem.release()

        self._futs.append((path, self._ex.submit(job)))

    def finish(self) -> list:
        """Join all writes; [(path, exception), ...] for the failures."""
        fails = []
        for path, fut in self._futs:
            try:
                fut.result()
            except OSError as e:
                fails.append((path, e))
        self._futs = []
        self._ex.shutdown(wait=True)
        return fails


# Decoded LR bytes per group of the folder and watch modes: one
# `api.upscale_batch` call each, with the next group decoded while this one
# computes.  The HR outputs are written behind and released per image, so
# this budget is what bounds the host memory held.
_GROUP_LR_BYTES = 128 << 20


def _decoded_groups(files, on_error=None):
    """Yield [(index, u8 image), ...] groups of about `_GROUP_LR_BYTES` of
    decoded pixels (read at call time), decoded on a
    thread pool one group ahead of the consumer.  An unreadable file is
    reported on stderr and skipped, or handed to ``on_error(index,
    exc)`` (called on the producer thread).  Closing the generator early
    stops the producer, which then drops the group it holds."""
    import concurrent.futures
    import queue
    import threading
    from collections import deque
    from rusty_sr_tpu_torch.utils.imageio import DECODE_ERRORS, load_image_u8

    budget_bytes = _GROUP_LR_BYTES
    out_q: queue.Queue = queue.Queue(maxsize=1)
    workers = max(1, min(8, os.cpu_count() or 2))
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                out_q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def decode(item):
        i, f = item
        try:
            return i, load_image_u8(f)
        except DECODE_ERRORS as e:
            return i, e

    def producer():
        group, used = [], 0
        try:
            with concurrent.futures.ThreadPoolExecutor(workers) as ex:
                # A bounded window of decodes, not the whole folder at once.
                futs: deque = deque()
                it = iter(enumerate(files))

                def refill():
                    while len(futs) < 2 * workers and not stop.is_set():
                        try:
                            futs.append(ex.submit(decode, next(it)))
                        except StopIteration:
                            return

                refill()
                while futs and not stop.is_set():
                    i, img = futs.popleft().result()
                    refill()
                    if isinstance(img, Exception):
                        if on_error is not None:
                            on_error(i, img)
                        else:
                            print(f"skipping {files[i]}: {img}",
                                  file=sys.stderr)
                        continue
                    group.append((i, img))
                    used += img.nbytes
                    if used >= budget_bytes:
                        if not put(group):
                            return
                        group, used = [], 0
            if group and not put(group):
                return
            put(None)
        except BaseException as e:   # the consumer raises it
            put(e)

    threading.Thread(target=producer, daemon=True).start()
    try:
        while True:
            item = out_q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def _upscale_group(args, tree, images, paths, writer, device,
                   mesh=None) -> None:
    """Upscale one decoded group of u8 ``images`` and hand each result to
    ``writer`` under its path in ``paths``: the neural modes in one
    `api.upscale_batch` call (over ``mesh`` when given), which submits
    each image the moment its last tile is scattered; the non-neural ones
    (``tree`` None) through `_simple`, image by image."""
    from rusty_sr_tpu_torch import api

    if tree is None:
        for img, path in zip(images, paths):
            writer.submit(path, _simple(args, img, device))
        return
    api.upscale_batch(images, tree, args.factor, fast=args.fast,
                      tile=args.tile, chunk=args.chunk, mesh=mesh,
                      on_image_done=lambda j, out: writer.submit(paths[j],
                                                                 out),
                      release_outputs=True, device=device)


def _run_upscale_folder(args, device, mesh=None) -> int:
    """Folder mode: every image in INPUT_FILE upscaled into the folder
    OUTPUT_FILE as ``stem.png``.

    The neural path is a pipeline of three stages: a decode pool stages
    bounded groups one group ahead; `api.upscale_batch` keeps up to
    ``_MAX_INFLIGHT`` chunks of tiles, which span images, on the card;
    and each image is encoded on a write-behind pool the moment its last
    tile is scattered; ``mesh`` splits each chunk over its devices.  The
    non-neural modes loop `_simple` over the images.  A failed write
    is reported and the run goes on; it then exits 1, as it does when no
    image in the folder is readable."""
    from rusty_sr_tpu_torch.train.data import list_images
    from rusty_sr_tpu_torch.utils.imageio import codec

    try:
        codec()
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    simple = args.downsample or args.parameters == "bilinear"
    if not simple and args.engine != "xla":
        print(f"error: folder mode supports --engine xla only (got "
              f"{args.engine!r})", file=sys.stderr)
        return 2
    files = list_images(args.INPUT_FILE)
    if not files:
        print(f"error: no images found in {args.INPUT_FILE!r}",
              file=sys.stderr)
        return 1
    os.makedirs(args.OUTPUT_FILE, exist_ok=True)
    out_paths = [os.path.join(args.OUTPUT_FILE, n)
                 for n in _output_names(files)]
    tree = None
    if not simple:
        tree = _load_weights(args)
        if isinstance(tree, int):
            return tree
        _fast_tier_tip(args)
    verb = ("Downsampling" if args.downsample else
            "Upscaling (bilinear)" if simple else "Upscaling")
    print(f"{verb} {len(files)} images" + ("" if simple else
          " (tiles batched across images"
          + (f", sharded over {mesh.shape['data']} devices" if mesh else "")
          + ")") + "...", end="", flush=True)
    writer = _AsyncWriter()
    n_done = 0
    try:
        for group in _decoded_groups(files):
            _upscale_group(args, tree, [im for _, im in group],
                           [out_paths[i] for i, _ in group], writer, device,
                           mesh)
            n_done += len(group)
    finally:
        fails = writer.finish()
    for path, e in fails:
        print(f"\nCould not write output file: {path}: {e}",
              file=sys.stderr)
    if n_done == 0:
        print("\nerror: no readable images", file=sys.stderr)
        return 1
    print(" Done")
    return 0 if not fails else 1


def _watch_scan(input_dir: str, done: dict, fails: dict) -> list:
    """One watch poll: the [(path, mtime), ...] to process now, and the
    bookkeeping pruned to what the folder holds now.

    ``done`` maps a path to the mtime processed; ``fails`` maps it to
    (mtime, failed attempts).  A file is skipped after three failed
    attempts until its mtime changes (a file still being copied is
    retried once the copy ends).  Entries of files no longer in the
    folder are dropped, so a watcher's state stays the size of the
    folder."""
    from rusty_sr_tpu_torch.train.data import list_images

    pending = []
    current = set()
    for f in list_images(input_dir):
        current.add(f)
        try:
            mt = os.path.getmtime(f)
        except OSError:
            continue
        if done.get(f) == mt:
            continue
        fmt, fc = fails.get(f, (None, 0))
        if fmt is not None and fmt != mt:
            fc = 0
        if fc >= 3:
            continue
        pending.append((f, mt))
    for d in (done, fails):
        for f in [k for k in d if k not in current]:
            del d[f]
    return pending


def run_watch(args) -> int:
    """The resident serving mode: each poll upscales the new or changed
    images of INPUT_DIR into OUTPUT_DIR, in groups through
    `api.upscale_batch`, until interrupted (or once, with ``--once``)."""
    import json
    import time

    if args.custom and args.parameters:
        print("error: --custom conflicts with --parameters", file=sys.stderr)
        return 2
    refused = _refused(args)
    if refused is not None:
        return refused
    tree = _load_weights(args)
    if isinstance(tree, int):
        return tree
    if not os.path.isdir(args.INPUT_DIR):
        print(f"error: {args.INPUT_DIR!r} is not a folder", file=sys.stderr)
        return 1
    device = device_for(args.platform)
    mesh, rc = _mesh_arg(args, device)
    if rc is not None:
        return rc
    os.makedirs(args.OUTPUT_DIR, exist_ok=True)
    _fast_tier_tip(args)
    mf = open(args.metrics, "a") if args.metrics else None
    done: dict = {}
    fails: dict = {}
    pick_name = _StableNamer()
    print(f"Watching {args.INPUT_DIR} (poll {args.poll}s; Ctrl-C to stop)",
          flush=True)
    try:
        while True:
            pending = _watch_scan(args.INPUT_DIR, done, fails)

            def on_decode_error(i, e, _pending=pending):
                # Possibly still being written: retried on later polls.
                f, mt = _pending[i]
                prev = fails.get(f)
                fc = prev[1] if prev and prev[0] == mt else 0
                fails[f] = (mt, fc + 1)
                if fc + 1 >= 3:
                    print(f"skipping {f}: {e}", file=sys.stderr)

            for group in _decoded_groups([f for f, _ in pending],
                                         on_error=on_decode_error):
                batch = [pending[i] for i, _ in group]
                imgs = [im for _, im in group]
                t0 = time.time()
                names = [pick_name(f) for f, _ in batch]
                writer = _AsyncWriter()
                try:
                    _upscale_group(args, tree, imgs,
                                   [os.path.join(args.OUTPUT_DIR, n)
                                    for n in names], writer, device, mesh)
                finally:
                    # A failed write must not end the resident watcher.
                    failed = dict(writer.finish())
                n_ok = 0
                for (f, mt), name in zip(batch, names):
                    e = failed.get(os.path.join(args.OUTPUT_DIR, name))
                    if e is not None:
                        fails[f] = (mt, fails.get(f, (mt, 0))[1] + 1)
                        print(f"could not write {name}: {e}",
                              file=sys.stderr)
                        continue
                    done[f] = mt
                    fails.pop(f, None)
                    n_ok += 1
                dt = time.time() - t0
                px = sum(im.shape[0] * im.shape[1] for im in imgs) \
                    * args.factor ** 2 / 1e6
                print(f"upscaled {n_ok} image(s), {px:.1f} HR MPix "
                      f"in {dt:.2f}s", flush=True)
                if mf is not None:
                    mf.write(json.dumps({
                        "images": n_ok, "failed": len(imgs) - n_ok,
                        "hr_mpix": round(px, 3), "latency_s": round(dt, 4),
                        "mpix_per_s": round(px / max(dt, 1e-9), 2),
                        "wall": time.time()}) + "\n")
                    mf.flush()
            if args.once:
                return 0
            time.sleep(args.poll)
    except KeyboardInterrupt:
        print("\nDone")
        return 0
    finally:
        if mf is not None:
            mf.close()


def run_train(args) -> int:
    """The ``train`` command: the reference's protocol on a folder, with
    checkpoints to PARAMETER_FILE (and ``--ckpt_dir``), on one device,
    or over a mesh of processes (`_train_local_ranks` for ``--mesh``;
    this process one rank with ``--coordinator``)."""
    from rusty_sr_tpu_torch.train.loop import TrainConfig

    if args.val_max is not None and not args.val_folder:
        print("error: --val_max requires --val_folder", file=sys.stderr)
        return 2
    resume_from = args.resume
    if resume_from == "":          # a bare --resume: use --ckpt_dir
        if not args.ckpt_dir:
            print("error: --resume without a DIR requires --ckpt_dir",
                  file=sys.stderr)
            return 2
        resume_from = args.ckpt_dir
    if resume_from is not None and args.start:
        print("error: --resume conflicts with -s/--start (a native "
              "checkpoint already contains the parameters)",
              file=sys.stderr)
        return 2
    refused = _refused(args)
    if refused is not None:
        return refused
    dist_flags = (args.coordinator, args.num_processes, args.process_id)
    multi = any(v is not None for v in dist_flags)
    if multi and any(v is None for v in dist_flags):
        print("error: multi-process training needs all of --coordinator, "
              "--num_processes and --process_id", file=sys.stderr)
        return 2
    if multi and not 0 <= args.process_id < args.num_processes:
        print(f"error: --process_id {args.process_id} is not in [0, "
              f"{args.num_processes})", file=sys.stderr)
        return 2
    axes = _parse_mesh_spec(args.mesh) if args.mesh else \
        {"data": args.num_processes if multi else 1, "spatial": 1,
         "model": 1}
    world = axes["data"] * axes["spatial"] * axes["model"]
    if multi and world != args.num_processes:
        print(f"error: --mesh {args.mesh} is {world} processes and must "
              f"equal --num_processes {args.num_processes} (one device a "
              f"process)", file=sys.stderr)
        return 2

    cfg = TrainConfig(factor=args.factor, linear_loss=args.linear_loss,
                      loss_kind=args.loss, amp=args.amp, trunk=args.trunk,
                      remat=args.remat, precision=args.precision)
    for flag, arg_v, attr in (("--ckpt_every", args.ckpt_every,
                               "checkpoint_every"),
                              ("--val_every", args.val_every, "val_every"),
                              ("--steps_per_dispatch",
                               args.steps_per_dispatch,
                               "steps_per_dispatch")):
        if arg_v is not None:
            if arg_v < 1:
                print(f"error: {flag} must be >= 1 (got {arg_v})",
                      file=sys.stderr)
                return 2
            setattr(cfg, attr, arg_v)
    if args.batch is not None:
        if args.batch < 1:
            print(f"error: --batch must be >= 1 (got {args.batch})",
                  file=sys.stderr)
            return 2
        cfg.batch_size = args.batch
    if args.crop is not None:
        if args.crop < cfg.factor or args.crop % cfg.factor:
            print(f"error: --crop must be a positive multiple of the "
                  f"factor {cfg.factor} (got {args.crop})", file=sys.stderr)
            return 2
        if cfg.trunk == "packed" and (args.crop // cfg.factor) % 2:
            print(f"error: --trunk packed needs an even LR crop "
                  f"(--crop {args.crop} / factor {cfg.factor} = "
                  f"{args.crop // cfg.factor}, odd)", file=sys.stderr)
            return 2
        cfg.crop = args.crop
    if cfg.batch_size % axes["data"]:
        print(f"error: batch size {cfg.batch_size} does not divide over "
              f"{axes['data']} processes (use --batch)", file=sys.stderr)
        return 2
    pair = 2 if cfg.trunk == "packed" else 1
    if axes["spatial"] > cfg.crop // cfg.factor // pair:
        print(f"error: --mesh spatial={axes['spatial']} is more shards "
              f"than the crop's {cfg.crop // cfg.factor // pair} LR "
              + ("row pairs" if pair > 1 else "rows") + " (use --crop)",
              file=sys.stderr)
        return 2
    device = device_for(args.platform)
    if world > 1 and not multi:
        _, rc = _mesh_arg(args, device)   # more ranks than devices
        return rc if rc is not None else _train_local_ranks(args, world)
    group = None
    if multi:
        import torch
        import torch.distributed as dist
        if device.type == "cuda":
            device = torch.device("cuda", args.process_id
                                  % torch.cuda.device_count())
            torch.cuda.set_device(device)
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=f"tcp://{args.coordinator}",
            world_size=args.num_processes, rank=args.process_id)
        group = dist.group.WORLD
    try:
        return _train(args, cfg, resume_from, device, group, axes)
    finally:
        if group is not None:
            dist.destroy_process_group()


def _train_local_ranks(args, world: int) -> int:
    """``train --mesh`` without the multi-process flags: one spawned
    process per mesh device, ranks 0..world-1 of a group over 127.0.0.1,
    each running this command's `train` on its own device.  Returns the
    first failing rank's exit code (the others are then stopped), or
    0."""
    import multiprocessing
    import multiprocessing.connection
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    procs = []
    for rank in range(world):
        rank_args = argparse.Namespace(**vars(args))
        rank_args.coordinator = f"127.0.0.1:{port}"
        rank_args.num_processes, rank_args.process_id = world, rank
        procs.append(ctx.Process(target=_train_rank, args=(rank_args,)))
    for p in procs:
        p.start()
    try:
        live = list(procs)
        while live:
            multiprocessing.connection.wait([p.sentinel for p in live])
            live = [p for p in live if p.exitcode is None]
            bad = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            if bad:
                return bad[0] if bad[0] > 0 else 1
        return 0
    finally:
        for p in procs:
            if p.exitcode is None:
                p.terminate()
            p.join()


def _train_rank(args) -> None:
    """One rank of `_train_local_ranks` (in a spawned process)."""
    sys.exit(run_train(args))


def _train(args, cfg, resume_from, device, group, axes) -> int:
    """`run_train` once its flags are checked: ``device`` is this
    process's, ``group`` the initialised process group or None, ``axes``
    the mesh's sizes."""
    from rusty_sr_tpu_torch import params as params_lib
    from rusty_sr_tpu_torch.parallel.mesh import grid_coords
    from rusty_sr_tpu_torch.train.data import CropPipeline, list_images
    from rusty_sr_tpu_torch.train.loop import train_loop, world_of
    from rusty_sr_tpu_torch.utils.imageio import DECODE_ERRORS, load_image_u8

    rank, world = world_of(group)
    at = grid_coords(rank, world, axes["spatial"], axes["model"])
    d, n_data = at["data"], at["n_data"]

    start = None
    if args.start:
        try:
            start = params_lib.load_rsr_file(args.start, cfg.factor)
        except OSError as e:
            print(f"Error opening start parameter file: {e}",
                  file=sys.stderr)
            return 1
        except ValueError as e:
            print(f"error: {e}. Ensure the start parameters were trained "
                  "with the same factor.", file=sys.stderr)
            return 1
    val_images = None
    if args.val_folder and rank == 0:   # rank 0 alone validates
        files = list_images(args.val_folder, args.recurse)
        if args.val_max is not None:
            files = files[: args.val_max]
        try:
            val_images = [load_image_u8(f).astype(np.float32) / 255.0
                          for f in files]
        except DECODE_ERRORS as e:
            print(f"error: validation image: {e}", file=sys.stderr)
            return 1
    try:
        # Each data index reads its stripe of the folder and crops its
        # share of every batch from the seed of its index, as the JAX
        # package seeds each process; the spatial and model ranks of a
        # data index crop the same images.
        buf = CropPipeline(args.TRAINING_FOLDER, recurse=args.recurse,
                           crop=(cfg.crop, cfg.crop),
                           batch_size=cfg.batch_size // n_data, seed=d,
                           workers=args.data_workers, out_dtype=np.uint8,
                           shard_across_hosts=n_data > 1, process_index=d,
                           process_count=n_data)
    except (ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if world > 1:
        print(f"multi-process: process {rank}/{world}, {len(buf.files)} "
              "training files in this process's stripe", flush=True)
    if rank == 0:
        print("Beginning Training")

    def batches():
        while True:
            yield buf.next_batch()

    try:
        train_loop(cfg, batches(), start_params=start,
                   param_file=args.PARAMETER_FILE, val_images=val_images,
                   validate=bool(args.val_folder), max_steps=args.max_steps,
                   metrics_file=args.metrics, native_ckpt_dir=args.ckpt_dir,
                   resume_from=resume_from, device=device, group=group,
                   n_spatial=axes["spatial"], n_model=axes["model"])
    except OSError as e:
        print(f"Could not make parameter file: {e}", file=sys.stderr)
        return 1
    except RuntimeError as e:
        # e.g. every training image unreadable, or a bad checkpoint
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        buf.close()
    if rank == 0:
        print("Done")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "train":
        args = build_train_parser().parse_args(argv[1:])
        runner = run_train
    elif argv and argv[0] == "watch":
        args = build_watch_parser().parse_args(argv[1:])
        runner = run_watch
    else:
        args = build_parser().parse_args(argv)
        runner = run_upscale
    if args.trace:
        from rusty_sr_tpu_torch.utils.profiling import trace
        with trace(args.trace):
            return runner(args)
    return runner(args)


if __name__ == "__main__":
    sys.exit(main())
