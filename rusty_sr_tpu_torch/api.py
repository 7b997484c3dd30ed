"""High-level Python API.

>>> import rusty_sr_tpu_torch
>>> hr = rusty_sr_tpu_torch.upscale(img_u8, weights="anime")  # uint8 out
>>> hr = rusty_sr_tpu_torch.upscale(img_u8, weights="anime", fast=True)
>>> hrs = rusty_sr_tpu_torch.upscale_batch([a_u8, b_u8], weights="anime")
>>> lr = rusty_sr_tpu_torch.downscale(img)                  # gamma-correct
>>> tree = rusty_sr_tpu_torch.train_folder("photos/", steps=1000,
...                                        param_file="mine.rsr")
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from rusty_sr_tpu_torch import params as params_lib


def _resolve_params(weights: Union[str, dict],
                    factor: Optional[int]) -> tuple:
    """(tree, factor): the weights by name, path or tree, and the factor
    they run at (`params.weights_factor`)."""
    if isinstance(weights, dict):
        tree = weights
    elif weights in params_lib.BUILTIN_WEIGHTS:
        tree = params_lib.load_builtin(weights, factor or 3)
    else:
        tree = params_lib.load_weights_file(weights, factor or 3)
    return tree, params_lib.weights_factor(tree, factor)


def upscale(image: np.ndarray, weights: Union[str, dict] = "imagenet",
            factor: Optional[int] = None, *, fast: bool = False,
            engine: str = "xla", tile: int = 242,
            chunk: Optional[int] = None, device="cuda") -> np.ndarray:
    """Upscale an (H,W,3) sRGB image by ``factor``.

    ``weights``: a builtin name ('imagenet', 'imagenetlinear', 'anime'),
    a path to a `.rsr` file, a parameter tree, or SwinIR or HAT weights (a
    state dict in the model's own layout, or a path to its ``.pth``),
    which run as `upscale_batch` runs them, on the xla engine only
    (ValueError on the others).  ``factor``: 3 for the
    reference's net when None; SwinIR and HAT weights upscale by their
    own scale and raise for another.  ``engine``: 'xla' (the
    default; the trunk as conv stages, the u8 path), 'fused' (the trunk
    as one kernel) or 'int8' (the trunk's merged stages on calibrated
    int8 products; the JAX package's quantisation experiment, which its
    CLI does not offer either).  ``fast`` runs the bf16 tier instead of
    the exact f32 tier.  ``device``: 'cuda' runs the kernels on the card,
    'cpu' their plain PyTorch versions.

    On the xla and int8 engines a uint8 image stays uint8 end to end and
    the result is uint8; elsewhere uint8 pixels are divided by 255 and the
    result is float32.  Float input must already be finite sRGB in [0, 1], and
    anything else raises.
    """
    from rusty_sr_tpu_torch.parallel.tiling import tiled_sr

    tree, factor = _resolve_params(weights, factor)
    image = np.asarray(image)
    if image.dtype == np.uint8:
        if engine not in ("xla", "int8"):
            image = image.astype(np.float32) / 255.0
    else:
        image = np.asarray(image, np.float32)
        # NaN fails both sides of a range check, so finiteness is explicit.
        if image.size and not (np.isfinite(image).all()
                               and image.min() >= -0.001
                               and image.max() <= 1.001):
            raise ValueError(
                "float input must be finite sRGB in [0, 1] (got range "
                f"[{image.min():.3g}, {image.max():.3g}]); pass uint8 "
                "pixels directly or divide by 255")
    return tiled_sr(tree, image, factor, tile=tile, chunk=chunk,
                    engine=engine, device=device,
                    compute_dtype=torch.bfloat16 if fast else None)


def upscale_batch(images, weights: Union[str, dict] = "imagenet",
                  factor: Optional[int] = None, *, fast: bool = False,
                  tile: int = 242,
                  chunk: Optional[int] = None, mesh=None,
                  on_image_done=None, release_outputs: bool = False,
                  device="cuda") -> list:
    """Upscale a list of images on the xla engine, with tiles batched
    across images (`parallel.tiling.tiled_sr_batch`, which the folder and
    watch modes run on).

    All images share one dtype: all uint8 (uint8 out) or all float in
    [0, 1] (float32 out).  ``on_image_done(i, out)`` fires in ascending
    ``i`` the moment image i is finished, while later tiles still
    compute, so that encoding overlaps the card; with
    ``release_outputs=True`` the returned list holds None for the images
    delivered.  ``mesh`` (`parallel.mesh.make_mesh`) splits each chunk of
    tiles over its data axis's devices in place of ``device``, with the
    same outputs.  ``weights`` and ``factor`` as in `upscale`: SwinIR
    and HAT weights run each frame whole as one tile of the chunk loop,
    frames of one size to a chunk, ``chunk`` frames to it (by default the
    model's ``DEFAULT_CHUNK``, one frame).  ``device`` as in
    `upscale`.
    """
    from rusty_sr_tpu_torch.parallel.tiling import tiled_sr_batch
    tree, factor = _resolve_params(weights, factor)
    return tiled_sr_batch(tree, [np.asarray(im) for im in images], factor,
                          tile=tile, chunk=chunk, mesh=mesh,
                          compute_dtype=torch.bfloat16 if fast else None,
                          on_image_done=on_image_done,
                          release_outputs=release_outputs, device=device)


def upscale_bilinear(image: np.ndarray, factor: int = 3, *,
                     device="cuda") -> np.ndarray:
    """Gamma-correct bilinear upscale (the reference's ``-p bilinear``)
    through the tile path.  uint8 in gives uint8 out; float in, float
    out."""
    from rusty_sr_tpu_torch.parallel.tiling import tiled_simple
    return tiled_simple(np.asarray(image), factor, mode="bilinear",
                        device=device)


def downscale(image: np.ndarray, factor: int = 3, *,
              device="cuda") -> np.ndarray:
    """Gamma-correct fxf mean downsample (the reference's ``-d``) through
    the tile path, after cropping the image to a multiple of ``factor``.
    uint8 in gives uint8 out; float in, float out."""
    from rusty_sr_tpu_torch.parallel.tiling import tiled_simple
    img = np.asarray(image)
    h, w, _ = img.shape
    return tiled_simple(img[: h - h % factor, : w - w % factor], factor,
                        mode="downsample", device=device)


def train_folder(folder: str, *, steps: Optional[int] = None,
                 factor: int = 3, recurse: bool = False,
                 start: Union[str, dict, None] = None,
                 param_file: Optional[str] = None,
                 linear_loss: bool = False, loss: str = "mse",
                 val_folder: Optional[str] = None,
                 val_max: Optional[int] = None,
                 metrics_file: Optional[str] = None,
                 ckpt_dir: Optional[str] = None,
                 resume_from: Optional[str] = None,
                 amp: bool = False, precision: str = "highest",
                 trunk: str = "merged", batch_size: Optional[int] = None,
                 crop: Optional[int] = None, remat: bool = False,
                 steps_per_dispatch: Optional[int] = None,
                 data_workers: Optional[int] = None,
                 checkpoint_every: Optional[int] = None,
                 val_every: Optional[int] = None,
                 seed: int = 0, device="cuda", group=None,
                 n_spatial: int = 1, n_model: int = 1) -> dict:
    """Train on an image folder with the reference's protocol; returns the
    final parameters (a numpy tree).

    ``start``: a `.rsr` path or a tree to start from (default: a fresh
    init from ``seed``).  ``param_file``: the `.rsr` written at the
    checkpoint cadence and at the end.  ``ckpt_dir``/``resume_from``:
    resumable checkpoints (parameters, Adam state, step).  ``amp``: bf16
    convolution operands with float32 sums, parameters and Adam state.
    ``trunk``: 'merged' (the default), 'flat' or 'packed' (the bf16
    space-to-depth trunk; needs an even LR crop).  ``batch_size`` (4) and
    ``crop`` (192, a multiple of the factor) size the batches;
    ``remat`` recomputes the forward in the backward pass;
    ``steps_per_dispatch`` batches are uploaded at once (10, clamped to
    the cadences); ``data_workers`` sizes the crop pool;
    ``checkpoint_every`` and ``val_every`` are the cadences in steps (100
    each, as the CLI's ``--ckpt_every`` and ``--val_every``).  ``device``:
    'cuda' trains on the card, 'cpu' on the CPU.  ``precision``: the
    float32 tiers' convolutions, 'highest' (exact) or 'high' (the
    three-term bf16 split, `ops.conv.conv2d_bf16x3`).

    ``group``: an initialised `torch.distributed` process group to train
    over, this process being one rank on ``device`` of a (data,
    ``n_spatial``, ``n_model``) mesh of its ranks
    (`train.loop.train_loop`): each data index d reads its stripe of the
    folder (`train.data.shard_files_for_host`) and crops ``batch_size /
    n_data`` of each batch from the seed ``seed + d``, the same crops on
    its spatial and model ranks; rank 0 alone validates and writes the
    files."""
    from rusty_sr_tpu_torch.parallel.mesh import grid_coords, rows
    from rusty_sr_tpu_torch.train.data import CropPipeline, list_images
    from rusty_sr_tpu_torch.train.loop import (TrainConfig, train_loop,
                                               world_of)
    from rusty_sr_tpu_torch.utils.imageio import load_image_u8

    if trunk not in ("merged", "flat", "packed"):
        raise ValueError(f"trunk must be merged/flat/packed, got {trunk!r}")
    if precision not in ("highest", "high"):
        raise ValueError(f"precision must be 'highest' or 'high', got "
                         f"{precision!r}")
    cfg = TrainConfig(factor=factor, linear_loss=linear_loss, loss_kind=loss,
                      amp=amp, trunk=trunk, remat=remat, precision=precision)
    if batch_size is not None:
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        cfg.batch_size = batch_size
    for name, v in (("steps_per_dispatch", steps_per_dispatch),
                    ("checkpoint_every", checkpoint_every),
                    ("val_every", val_every)):
        if v is not None:
            if v < 1:
                raise ValueError(f"{name} must be >= 1")
            setattr(cfg, name, v)
    if crop is not None:
        if crop < factor or crop % factor:
            raise ValueError(f"crop must be a positive multiple of the "
                             f"factor {factor} (got {crop})")
        cfg.crop = crop
    if trunk == "packed" and (cfg.crop // factor) % 2:
        raise ValueError(f"trunk='packed' needs an even LR crop "
                         f"(crop {cfg.crop} / factor {factor} is odd)")
    start_tree = start
    if isinstance(start, str):
        start_tree = params_lib.load_rsr_file(start, factor)
    rank, world = world_of(group)
    at = grid_coords(rank, world, n_spatial, n_model)
    d, n_data = at["data"], at["n_data"]
    if cfg.batch_size % n_data:
        raise ValueError(f"batch_size {cfg.batch_size} does not divide over "
                         f"{n_data} data-parallel processes")
    # ValueError for more spatial shards than the crop has LR rows (pairs)
    rows(cfg.crop // factor, n_spatial, 0, 2 if trunk == "packed" else 1)
    val_images = None
    if val_folder and rank == 0:
        files = list_images(val_folder, recurse)
        if val_max is not None:
            files = files[:val_max]
        val_images = [load_image_u8(f).astype(np.float32) / 255.0
                      for f in files]
    buf = CropPipeline(folder, recurse=recurse, crop=(cfg.crop, cfg.crop),
                       batch_size=cfg.batch_size // n_data, seed=seed + d,
                       workers=data_workers, out_dtype=np.uint8,
                       shard_across_hosts=n_data > 1, process_index=d,
                       process_count=n_data)

    def batches():
        while True:
            yield buf.next_batch()

    try:
        return train_loop(cfg, batches(), start_params=start_tree,
                          param_file=param_file, val_images=val_images,
                          max_steps=steps, metrics_file=metrics_file,
                          native_ckpt_dir=ckpt_dir, resume_from=resume_from,
                          validate=bool(val_folder), seed=seed,
                          device=device, group=group, n_spatial=n_spatial,
                          n_model=n_model)
    finally:
        buf.close()
