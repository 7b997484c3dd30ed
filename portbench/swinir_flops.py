"""SwinIR's work counts for the benchmark: the model's useful FLOP per LR
pixel, and the window-attention kernel's operations and bytes.

Counted from the configuration's published widths, the work the network
needs whatever implements it: the linear layers, the attention products
and the convolutions at 2 FLOP a multiply-add, each at the resolution it
runs at, with no reflect padding (the frame's own pixels) and nothing for
LayerNorm, GELU, softmax or the adds.  The kernel's bytes are its inputs
read once and its output written once, in bf16.
"""

from __future__ import annotations

from portbench.flops import PEAKS

WINDOW_TOKENS = 64      # an 8 x 8 window


def blocks(cfg: dict) -> int:
    """Transformer blocks: 36 for SwinIR-M."""
    return sum(cfg["depths"])


def attn_flop_per_token(cfg: dict) -> int:
    """q k^T and P v, per token and block: 2 products x 64 keys x C x 2
    FLOP = 46,080 at C = 180."""
    n = cfg["window_size"] ** 2
    return 2 * 2 * n * cfg["embed_dim"]


def attn_bytes_per_token(cfg: dict) -> int:
    """q, k and v read (3C bf16) and the output written (C bf16), per
    token and block: 1,440 at C = 180."""
    return 4 * cfg["embed_dim"] * 2


def block_flop_per_token(cfg: dict) -> int:
    """One transformer block per token: qkv (C -> 3C), attention, proj
    (C -> C), fc1 (C -> rC) and fc2 (rC -> C)."""
    c = cfg["embed_dim"]
    hidden = int(c * cfg["mlp_ratio"])
    return 2 * (c * 3 * c + c * c + 2 * c * hidden) + attn_flop_per_token(cfg)


def conv_flop(k: int, c_in: int, c_out: int) -> int:
    return 2 * k * k * c_in * c_out


def forward_flop_per_lr_px(cfg: dict) -> int:
    """The whole forward per LR pixel: conv_first, the blocks, one 3x3
    convolution per residual group, conv_after_body,
    conv_before_upsample, the upsample convolutions (each at its side's
    resolution, x4 pixels after each shuffle) and conv_last at the HR
    side.  26,150,616 for SwinIR-M x4."""
    c, nf, s = cfg["embed_dim"], cfg["num_feat"], cfg["upscale"]
    total = conv_flop(3, cfg["in_chans"], c)
    total += blocks(cfg) * block_flop_per_token(cfg)
    total += len(cfg["depths"]) * conv_flop(3, c, c)
    total += conv_flop(3, c, c) + conv_flop(3, c, nf)
    px, scale = 1, s
    while scale > 1:
        total += px * conv_flop(3, nf, 4 * nf)
        px *= 4
        scale //= 2
    return total + px * conv_flop(3, nf, cfg["out_chans"])


def padded_tokens(cfg: dict, h: int, w: int) -> int:
    """Tokens of an h x w frame once reflect-padded to whole windows."""
    ws = cfg["window_size"]
    return (h + (-h) % ws) * (w + (-w) % ws)


def window_attn_bound_s(cfg: dict, tokens: int) -> float:
    """Least seconds for the window-attention kernel over ``tokens``
    padded tokens in every block: the larger of its operations at the
    bf16 dense peak and its bytes at the HBM rate."""
    n = tokens * blocks(cfg)
    return max(n * attn_flop_per_token(cfg) / PEAKS["bf16_flop_s"],
               n * attn_bytes_per_token(cfg) / PEAKS["hbm_bytes_s"])
