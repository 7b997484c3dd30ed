"""High-level Python API.

>>> import rusty_sr_tpu_torch
>>> hr = rusty_sr_tpu_torch.upscale(img_u8, weights="anime")  # uint8 out
>>> hr = rusty_sr_tpu_torch.upscale(img_u8, weights="anime", fast=True)
>>> hrs = rusty_sr_tpu_torch.upscale_batch([a_u8, b_u8], weights="anime")
>>> lr = rusty_sr_tpu_torch.downscale(img)                  # gamma-correct
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from rusty_sr_tpu_torch import params as params_lib


def _resolve_params(weights: Union[str, dict], factor: int) -> dict:
    if isinstance(weights, dict):
        return weights
    if weights in params_lib.BUILTIN_WEIGHTS:
        return params_lib.load_builtin(weights, factor)
    return params_lib.load_rsr_file(weights, factor)


def upscale(image: np.ndarray, weights: Union[str, dict] = "imagenet",
            factor: int = 3, *, fast: bool = False, engine: str = "xla",
            tile: int = 242, chunk: Optional[int] = None,
            device="cuda") -> np.ndarray:
    """Upscale an (H,W,3) sRGB image by ``factor``.

    ``weights``: a builtin name ('imagenet', 'imagenetlinear', 'anime'),
    a path to a `.rsr` file, or a parameter tree.  ``engine``: 'xla' (the
    default; the trunk as conv stages, the u8 path) or 'fused' (the trunk
    as one kernel).  ``fast`` runs the bf16 tier instead of the exact f32
    tier.  ``device``: 'cuda' runs the kernels on the card, 'cpu' their
    plain PyTorch versions.

    On the xla engine a uint8 image stays uint8 end to end and the result
    is uint8; elsewhere uint8 pixels are divided by 255 and the result is
    float32.  Float input must already be finite sRGB in [0, 1], and
    anything else raises.
    """
    from rusty_sr_tpu_torch.parallel.tiling import tiled_sr

    tree = _resolve_params(weights, factor)
    image = np.asarray(image)
    if image.dtype == np.uint8:
        if engine != "xla":
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
                  factor: int = 3, *, fast: bool = False, tile: int = 242,
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
    delivered.  ``mesh`` is not ported yet and raises.  ``device`` as in
    `upscale`.
    """
    from rusty_sr_tpu_torch.parallel.tiling import tiled_sr_batch
    tree = _resolve_params(weights, factor)
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
