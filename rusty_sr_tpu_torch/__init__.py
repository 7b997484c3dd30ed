"""rusty_sr_tpu_torch — the PyTorch and CUDA port of the JAX package.

A second package beside the JAX one, for one NVIDIA Hopper GPU.  It
imports neither JAX nor `rusty_sr_tpu`; it reads the same `.rsr` weight
files and keeps the JAX package's NHWC / HWIO layouts at its public
functions.  Ported so far: the single-image upscale through the fused
engine, in its exact (f32) and fast (bf16) tiers, whose trunk is the
hand-written CUDA kernel `csrc/trunk.cu` and whose output passes through
the depth-to-space kernel `csrc/shuffle.cu`; and the bilinear and
downsample modes.
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
    upscale,
    upscale_bilinear,
)
