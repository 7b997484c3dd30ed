"""The SR network and its weight merging, as plain PyTorch; the int8
trunk (`quant`); SwinIR (`swinir`)."""
from rusty_sr_tpu_torch.models.sr_net import (  # noqa: F401
    bilinear_apply,
    downsample_apply,
    make_lr_from_hr,
    sr_apply,
)
