"""Parameter store: `.rsr` codec, flat<->tree layout, initialisation.

The same wire format and flat ordering as `rusty_sr_tpu/params.py`:

    u32 LE  N                 element count
    u32 LE  size[i] * N       per-element byte-size table (always 4)
    f32 LE  value[i] * N      payload

Conv weight blocks are row-major ``(C_out, k_h, k_w, C_in)`` in the file
and HWIO in the tree, so the tree is interchangeable with the JAX
package's.  Everything here is numpy; `save_rsr_file` writes a tree
back to a `.rsr` file, and `to_torch` moves a tree onto a
device.  The builtin weight blobs are read by path from the JAX
package's ``weights/`` folder (reading a file imports nothing).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple

import numpy as np

Pytree = Dict[str, np.ndarray]

# Per-op MSRA gains used by the reference (conv0 1.0, all others 0.1).
_CONV_GAINS = {
    "conv0": 1.0,
    "conv1": 0.1, "conv2": 0.1, "conv3": 0.1,
    "conv5": 0.1, "conv6": 0.1, "conv7": 0.1,
    "conv8": 0.1, "conv9": 0.1, "conv10": 0.1,
}

BUILTIN_WEIGHTS = ("imagenet", "imagenetlinear", "anime")


def _builtin_dir() -> str:
    """Directory of the builtin `.rsr` blobs: ``RUSTY_SR_TPU_WEIGHTS_DIR``
    if set, else ``rusty_sr_tpu/weights`` beside this package."""
    env = os.environ.get("RUSTY_SR_TPU_WEIGHTS_DIR")
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, "rusty_sr_tpu", "weights")


def param_specs(factor: int, width: int = 32,
                channels: int = 3) -> List[Tuple[str, Tuple[int, ...]]]:
    """Ordered (name, OHWI-shape) spec of the flat parameter vector."""
    n = width
    e = channels * factor * factor
    return [
        ("conv0", (n, 5, 5, channels)),
        ("f_bias", (n,)),
        ("f_belu", (n,)),
        ("expand_bias", (e,)),
        ("l1_bias", (n,)), ("l2_bias", (n,)), ("l3_bias", (n,)),
        ("l1_belu", (n,)), ("l2_belu", (n,)), ("l3_belu", (n,)),
        ("conv1", (n, 5, 5, n)), ("conv2", (n, 5, 5, n)), ("conv3", (n, 5, 5, n)),
        ("conv5", (n, 3, 3, n)), ("conv6", (n, 3, 3, n)),
        ("conv7", (e, 3, 3, n)),
        ("conv8", (n, 3, 3, n)),
        ("conv9", (e, 3, 3, n)), ("conv10", (e, 3, 3, n)),
    ]


def num_params(factor: int, width: int = 32, channels: int = 3) -> int:
    """Total flat parameter count (130,459 for factor=3)."""
    return sum(int(np.prod(s)) for _, s in param_specs(factor, width, channels))


def decode_rsr(data: bytes) -> np.ndarray:
    """Decode a bytevec-framed `.rsr` blob into a flat f32 vector."""
    if len(data) < 4:
        raise ValueError("rsr blob too short for header")
    (n,) = struct.unpack_from("<I", data, 0)
    expected = 4 + 8 * n
    if len(data) != expected:
        raise ValueError(f"rsr blob length {len(data)} != {expected} for N={n}")
    sizes = np.frombuffer(data, dtype="<u4", count=n, offset=4)
    if not np.all(sizes == 4):
        raise ValueError("rsr size table contains non-f32 entries")
    return np.frombuffer(data, dtype="<f4", count=n, offset=4 + 4 * n).copy()


def encode_rsr(flat: np.ndarray) -> bytes:
    """Encode a flat f32 vector in the reference's bytevec framing."""
    flat = np.ascontiguousarray(flat, dtype="<f4")
    n = flat.size
    return (struct.pack("<I", n) + np.full(n, 4, dtype="<u4").tobytes()
            + flat.tobytes())


def flat_to_pytree(flat: np.ndarray, factor: int, width: int = 32,
                   channels: int = 3) -> Pytree:
    """Split the flat vector into named arrays; convs become HWIO.

    Every leaf is a copy, so later writes to ``flat`` never leak into the
    tree."""
    specs = param_specs(factor, width, channels)
    total = sum(int(np.prod(s)) for _, s in specs)
    if flat.size != total:
        raise ValueError(f"flat vector has {flat.size} params, expected {total}")
    tree: Pytree = {}
    off = 0
    for name, shape in specs:
        cnt = int(np.prod(shape))
        block = np.array(flat[off:off + cnt], dtype=np.float32,
                         copy=True).reshape(shape)
        if len(shape) == 4:
            block = np.ascontiguousarray(block.transpose(1, 2, 3, 0))  # OHWI -> HWIO
        tree[name] = block
        off += cnt
    return tree


def pytree_to_flat(tree: Pytree, factor: int, width: int = 32,
                   channels: int = 3) -> np.ndarray:
    """Inverse of `flat_to_pytree` — emits the reference's flat ordering."""
    parts = []
    for name, shape in param_specs(factor, width, channels):
        block = np.asarray(tree[name], dtype=np.float32)
        if len(shape) == 4:
            block = block.transpose(3, 0, 1, 2)  # HWIO -> OHWI
        if block.shape != shape:
            raise ValueError(f"{name}: shape {block.shape} != spec {shape}")
        parts.append(block.reshape(-1))
    return np.concatenate(parts)


def init_params(rng: np.random.Generator | int, factor: int, width: int = 32,
                channels: int = 3) -> Pytree:
    """Fresh parameters matching the reference init scheme.

    - Convs: MSRA ``std = gain * sqrt(2 / fan_in)`` with per-op gains.
    - Biases: zero.
    - BeLU slopes: p alternates 1, 0, 1, 0... across channels.
    """
    if not isinstance(rng, np.random.Generator):
        rng = np.random.default_rng(rng)
    tree: Pytree = {}
    for name, shape in param_specs(factor, width, channels):
        if len(shape) == 4:
            c_out, kh, kw, c_in = shape
            std = _CONV_GAINS[name] * np.sqrt(2.0 / (kh * kw * c_in))
            w = rng.normal(0.0, std, size=shape).astype(np.float32)
            tree[name] = np.ascontiguousarray(w.transpose(1, 2, 3, 0))
        elif name.endswith("_belu"):
            p = np.zeros(shape, dtype=np.float32)
            p[0::2] = 1.0
            tree[name] = p
        else:
            tree[name] = np.zeros(shape, dtype=np.float32)
    return tree


def load_rsr_file(path: str, factor: int) -> Pytree:
    """Load a custom `.rsr` parameter file (the CLI's ``-c/--custom``)."""
    with open(path, "rb") as f:
        return flat_to_pytree(decode_rsr(f.read()), factor)


def is_checkpoint_path(path: str) -> bool:
    """A PyTorch checkpoint file (``.pth``, ``.pt``), as SwinIR's and
    HAT's released weights are, rather than a `.rsr` file."""
    return str(path).lower().endswith((".pth", ".pt"))


def load_weights_file(path: str, factor: int = 3):
    """A parameter file by its kind: a SwinIR or HAT checkpoint
    (`models.load_pth`, its own scale) or a `.rsr` file of the
    reference's net at ``factor``."""
    if is_checkpoint_path(path):
        from rusty_sr_tpu_torch.models import load_pth
        return load_pth(path)
    return load_rsr_file(path, factor)


def weights_factor(tree, factor=None) -> int:
    """The factor to run ``tree`` at: a SwinIR or HAT state dict's own
    scale (ValueError if ``factor`` names another), else ``factor``, 3
    when None."""
    from rusty_sr_tpu_torch.models import whole_frame_model
    model = whole_frame_model(tree)
    if model is not None:
        s = model.config_of(tree)["upscale"]
        if factor is not None and factor != s:
            raise ValueError(f"the {model.NAME} weights upscale x{s}, not "
                             f"x{factor}")
        return s
    return 3 if factor is None else factor


def load_builtin(name: str, factor: int = 3) -> Pytree:
    """Load one of the three builtin weight sets by name."""
    if name not in BUILTIN_WEIGHTS:
        raise ValueError(f"unknown builtin weights {name!r}; "
                         f"choose from {BUILTIN_WEIGHTS}")
    return load_rsr_file(os.path.join(_builtin_dir(), f"{name}.rsr"), factor)


def save_rsr_file(path: str, tree, factor: int) -> None:
    """Write a tree in the `.rsr` framing (the reference's training
    checkpoint; byte for byte `rusty_sr_tpu/params.py::save_rsr_file`).
    The width is read from the tree (32 for the reference's net)."""
    width = int(np.shape(tree["f_bias"])[0])
    with open(path, "wb") as f:
        f.write(encode_rsr(pytree_to_flat(tree, factor, width)))


def to_torch(tree, device) -> dict:
    """A numpy (or JAX) parameter tree -> float32 tensors on ``device``."""
    import torch
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in tree.items()}
