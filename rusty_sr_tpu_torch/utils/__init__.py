"""Host-side image I/O, tile gather/scatter and profiling."""
from rusty_sr_tpu_torch.utils.imageio import (  # noqa: F401
    load_image,
    psnr,
    save_image,
)
