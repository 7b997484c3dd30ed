"""Overlap-tile inference, and a device mesh's axes."""
from rusty_sr_tpu_torch.parallel.tiling import HALO, tiled_sr  # noqa: F401
from rusty_sr_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    make_sharded_apply,
    shard_batch,
    tiled_sr_sharded,
)
