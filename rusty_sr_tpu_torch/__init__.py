"""rusty_sr_tpu_torch — the PyTorch and CUDA port of the JAX package.

A second package beside the JAX one, for NVIDIA Hopper GPUs.  It imports
neither JAX nor `rusty_sr_tpu`; it reads the same `.rsr` weight files,
keeps the JAX package's NHWC / HWIO layouts at its public functions and
exports the same names from the same places.  It does what the JAX
package does: the upscale through its three engines — xla (the default:
u8 tiles in and out, the trunk as conv stages, its bf16 convs on the
hand-written conv-stage kernel `csrc/conv_stage.cu` and its output
through the epilogue in `csrc/shuffle.cu`; with the JAX package's
variant knobs), fused (the trunk as the hand-written kernel
`csrc/trunk.cu`) and int8 (the trunk's merged stages on calibrated int8
products, `models.quant`) — in the exact (f32) and fast (bf16) tiers;
the bilinear and downsample modes; SwinIR (`models.swinir`) and HAT
(`models.hat`), each from its own state dict or ``.pth``, on the batch
path, whole frames a tile, with the fused attention kernels
`csrc/window_attn.cu` and `csrc/hat_attn.cu`; serving —
`upscale_batch` and the CLI's folder and watch modes, with tiles batched across images, a native
host codec and pinned, stream-ordered copies; training — `train_folder`
and the CLI's ``train`` (f32, ``--amp``, ``--trunk packed``,
``--precision high``), with the crop feed, `.rsr` and torch checkpoints
and validation through the epilogue kernel; the JAX package's device
mesh (`parallel.mesh`: tile serving over the data axis, training over
`torch.distributed` on the data, spatial and model axes); and
`utils.profiling.device_timer`, a device timer on CUDA events.
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
from rusty_sr_tpu_torch.models.sr_net import (  # noqa: F401
    bilinear_apply,
    downsample_apply,
    sr_apply,
)
from rusty_sr_tpu_torch.api import (  # noqa: F401
    downscale,
    train_folder,
    upscale,
    upscale_batch,
    upscale_bilinear,
)
