"""The SR network and its weight merging, as plain PyTorch; the int8
trunk (`quant`); the transformers that run whole frames, SwinIR
(`swinir`) and HAT (`hat`), and the one function that tells their
weights apart (`whole_frame_model`)."""
from rusty_sr_tpu_torch.models.sr_net import (  # noqa: F401
    bilinear_apply,
    downsample_apply,
    make_lr_from_hr,
    sr_apply,
)


def whole_frame_model(tree):
    """The module of the network that runs ``tree`` a whole frame at a
    time: `hat` for a HAT state dict, `swinir` for a SwinIR one (wrapped
    or bare), None for anything else (the reference's net, on the tile
    grid).  Each module has ``NAME``, ``config_of``, ``prepare``,
    ``forward``, ``DEFAULT_CHUNK`` and ``HALO``."""
    from rusty_sr_tpu_torch.models import hat, swinir
    if hat.is_hat(tree):
        return hat
    if swinir.is_swinir(tree):
        return swinir
    return None


def load_pth(path: str) -> dict:
    """A SwinIR or HAT checkpoint file (``torch.save`` of a state dict,
    wrapped in ``params_ema`` or ``params`` or bare) -> its state dict;
    ValueError for a file that holds neither."""
    import torch

    from rusty_sr_tpu_torch.models.swinir import unwrap
    tree = unwrap(torch.load(path, map_location="cpu", weights_only=True))
    if whole_frame_model(tree) is None:
        raise ValueError(f"{path} holds no SwinIR or HAT state dict (no "
                         "'conv_first.weight' and 'layers.0...qkv.weight')")
    return tree
