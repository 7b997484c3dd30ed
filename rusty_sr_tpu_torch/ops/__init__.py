"""Ops on NHWC float32 tensors, step for step those of `rusty_sr_tpu/ops`.
The hand-written kernels live in `ops.cuda`, which this package does not
import (and nothing here builds or loads one)."""
from rusty_sr_tpu_torch.ops.activations import belu  # noqa: F401
from rusty_sr_tpu_torch.ops.color import (  # noqa: F401
    linear_to_srgb,
    srgb_to_linear,
)
from rusty_sr_tpu_torch.ops.conv import conv2d_same  # noqa: F401
from rusty_sr_tpu_torch.ops.pixel_shuffle import (  # noqa: F401
    depth_to_space,
    space_to_depth,
)
from rusty_sr_tpu_torch.ops.resize import avg_pool, upsample_bilinear  # noqa: F401
