"""sRGB <-> linear transfer functions (IEC 61966-2-1), the arithmetic of
`rusty_sr_tpu/ops/color.py` step for step, with the same clamps."""

from __future__ import annotations

import torch


def srgb_to_linear(s: torch.Tensor) -> torch.Tensor:
    """s <= 0.04045 ? s/12.92 : ((s + 0.055)/1.055)^2.4."""
    base = torch.clamp_min((s + 0.055) / 1.055, 1e-12)
    return torch.where(s <= 0.04045, s / 12.92, base ** 2.4)


def linear_to_srgb(lin: torch.Tensor) -> torch.Tensor:
    """l <= 0.0031308 ? 12.92*l : 1.055*l^(1/2.4) - 0.055."""
    base = torch.clamp_min(lin, 1e-12)
    return torch.where(lin <= 0.0031308, 12.92 * lin,
                       1.055 * base ** (1.0 / 2.4) - 0.055)
