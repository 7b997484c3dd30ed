"""rusty_sr_tpu_torch — the PyTorch and CUDA port of the JAX package.

A second package beside the JAX one, for one NVIDIA Hopper GPU.  It
imports neither JAX nor `rusty_sr_tpu`; it reads the same `.rsr` weight
files and keeps the JAX package's NHWC / HWIO layouts at its public
functions.  Ported so far: the single-image upscale through both
engines of the JAX package — xla (the default: u8 tiles in and out, the
trunk as conv stages; its bf16 convs on the hand-written conv-stage
kernel `csrc/conv_stage.cu` and its output through the epilogue in
`csrc/shuffle.cu`) and fused (the trunk as the hand-written kernel
`csrc/trunk.cu`, its output through the depth-to-space kernel) — in the
exact (f32) and fast (bf16) tiers; the bilinear and downsample modes;
serving — `upscale_batch` and the CLI's folder and watch modes, with
tiles batched across images, a native host codec and pinned,
stream-ordered copies; training — `train_folder` and the CLI's
``train`` (float32 merged and flat trunks, ``--amp``, ``--trunk
packed``), with the crop feed, `.rsr` and torch checkpoints, and
validation through the epilogue kernel; and the data axis of the JAX
package's mesh — tile serving split over several devices
(`parallel.mesh`) and data-parallel training over `torch.distributed`.
"""

__version__ = "0.1.0"

from rusty_sr_tpu_torch.params import (  # noqa: F401
    BUILTIN_WEIGHTS,
    decode_rsr,
    encode_rsr,
    flat_to_pytree,
    init_params,
    load_builtin,
    num_params,
    pytree_to_flat,
    to_torch,
)
from rusty_sr_tpu_torch.api import (  # noqa: F401
    downscale,
    train_folder,
    upscale,
    upscale_batch,
    upscale_bilinear,
)
