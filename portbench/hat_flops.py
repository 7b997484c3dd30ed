"""HAT's work counts for the benchmark: the model's useful FLOP per LR
pixel, and the attention kernels' and the three-term add-and-normalise's
operations and bytes.

Counted from the configuration's published widths, the work the network
needs whatever implements it: the linear layers, the attention products
and the convolutions at 2 FLOP a multiply-add, each at the resolution it
runs at, with no reflect padding (the frame's own pixels) and nothing for
LayerNorm, GELU, softmax, the adds or the channel attention's 1x1
convolutions (a few thousand FLOP a frame).  A kernel's bytes are its
inputs read once and its output written once, in bf16 (f32 where the
kernel reads or writes f32), plus the relative-position table that the
attention kernels read once per window and head.
"""

from __future__ import annotations

from portbench.flops import PEAKS


def blocks(cfg: dict) -> int:
    """Hybrid attention blocks: 36 at the published widths."""
    return sum(cfg["depths"])


def groups(cfg: dict) -> int:
    """Residual groups, each closed by one OCAB: 6."""
    return len(cfg["depths"])


def overlap_window(cfg: dict) -> int:
    """The OCAB's key window: 24 for window 16 at ratio 0.5."""
    ws = cfg["window_size"]
    return ws + int(ws * cfg["overlap_ratio"])


def sa_flop_per_token(cfg: dict) -> int:
    """q k^T and P v per token and hybrid block, over the window's keys:
    2 x 2 x 256 x C = 184,320 at C = 180."""
    return 4 * cfg["window_size"] ** 2 * cfg["embed_dim"]


def oca_flop_per_token(cfg: dict) -> int:
    """The same over the 24 x 24 overlapping keys, per token and OCAB:
    414,720."""
    return 4 * overlap_window(cfg) ** 2 * cfg["embed_dim"]


def attn_bytes_per_token(cfg: dict) -> int:
    """q, k and v read (3C bf16) and the output written (C bf16), per
    token and attention block: 1,440 at C = 180."""
    return 4 * cfg["embed_dim"] * 2


def table_bytes_per_token(cfg: dict, key_window: int) -> float:
    """The relative-position table (TW^2 f32 a head) that a kernel reads
    once per window and head, per token: 90.1 bytes at window 16 (TW 31),
    142.6 for the 24 x 24 keys (TW 39), with 6 heads."""
    ws = cfg["window_size"]
    tw = ws + key_window - 1
    return cfg["num_heads"][0] * tw * tw * 4 / ws ** 2


def linear_flop_per_token(cfg: dict) -> int:
    """qkv (C -> 3C), proj (C -> C), fc1 (C -> rC) and fc2 (rC -> C)."""
    c = cfg["embed_dim"]
    hidden = int(c * cfg["mlp_ratio"])
    return 2 * (c * 3 * c + c * c + 2 * c * hidden)


def conv_flop(k: int, c_in: int, c_out: int) -> int:
    return 2 * k * k * c_in * c_out


def cab_flop_per_px(cfg: dict) -> int:
    """The hybrid block's convolution branch: 3x3 C -> C / compress ->
    C."""
    c = cfg["embed_dim"]
    mid = c // cfg["compress_ratio"]
    return conv_flop(3, c, mid) + conv_flop(3, mid, c)


def forward_flop_per_lr_px(cfg: dict) -> int:
    """The whole forward per LR pixel: conv_first, the hybrid blocks
    (linear layers, window attention, the branch), the OCABs (linear
    layers, overlapping attention), one 3x3 convolution per group,
    conv_after_body, conv_before_upsample, the upsample convolutions
    (each at its side's resolution) and conv_last at the HR side.
    50,722,776 for HAT x4."""
    c, nf, s = cfg["embed_dim"], cfg["num_feat"], cfg["upscale"]
    lin = linear_flop_per_token(cfg)
    total = conv_flop(3, cfg["in_chans"], c)
    total += blocks(cfg) * (lin + sa_flop_per_token(cfg)
                            + cab_flop_per_px(cfg))
    total += groups(cfg) * (lin + oca_flop_per_token(cfg)
                            + conv_flop(3, c, c))
    total += conv_flop(3, c, c) + conv_flop(3, c, nf)
    px, scale = 1, s
    while scale > 1:
        total += px * conv_flop(3, nf, 4 * nf)
        px *= 4
        scale //= 2
    return total + px * conv_flop(3, nf, cfg["out_chans"])


def padded_tokens(cfg: dict, h: int, w: int) -> int:
    """Tokens of an h x w frame once reflect-padded to whole windows:
    544 x 960 for a 540p frame."""
    ws = cfg["window_size"]
    return (h + (-h) % ws) * (w + (-w) % ws)


def _bound_s(flop: float, nbytes: float) -> float:
    return max(flop / PEAKS["bf16_flop_s"], nbytes / PEAKS["hbm_bytes_s"])


def sa_bound_s(cfg: dict, tokens: int) -> float:
    """Least seconds for the window-16 attention kernel over ``tokens``
    padded tokens in every hybrid block: the larger of its FLOP at the bf16
    dense peak and its bytes (q, k, v, output and the table) at the HBM
    rate."""
    n = tokens * blocks(cfg)
    return _bound_s(n * sa_flop_per_token(cfg),
                    n * (attn_bytes_per_token(cfg) + table_bytes_per_token(
                        cfg, cfg["window_size"])))


def oca_bound_s(cfg: dict, tokens: int) -> float:
    """The same for the overlapping cross-attention kernel, in every
    OCAB."""
    n = tokens * groups(cfg)
    return _bound_s(n * oca_flop_per_token(cfg),
                    n * (attn_bytes_per_token(cfg) + table_bytes_per_token(
                        cfg, overlap_window(cfg))))


def add3_bytes_per_token(cfg: dict) -> int:
    """The hybrid block's add + norm, per padded token and block: x (f32)
    and the two bf16 terms read, the sum (f32) and its norm (bf16)
    written: 14 C = 2,520 bytes at C = 180 (the per-frame scale, C f32,
    is left out)."""
    return 14 * cfg["embed_dim"]


def add3_bound_s(cfg: dict, tokens: int) -> float:
    """Least seconds for the three-term add + norm launches over
    ``tokens`` padded tokens in every hybrid block: bytes at the HBM
    rate (about 12 FLOP an element)."""
    n = tokens * blocks(cfg)
    return _bound_s(n * 12 * cfg["embed_dim"], n * add3_bytes_per_token(cfg))


def add2_bytes_per_token(cfg: dict) -> int:
    """The two-term add + norm launches, per padded token and frame: 12 C
    for each that adds (x f32 and y bf16 read, the sum f32 and its norm or
    cast bf16 written): one a hybrid block (after its MLP), two an OCAB
    and one a group (its convolution plus the group's input); and 6 C for
    each of the two that do not (the patch embedding's norm and the first
    block's norm1): 118,800 bytes at the published widths."""
    c = cfg["embed_dim"]
    return 12 * c * (blocks(cfg) + 3 * groups(cfg)) + 2 * 6 * c


def add2_bound_s(cfg: dict, tokens: int) -> float:
    """Least seconds for the two-term add + norm launches over ``tokens``
    padded tokens: bytes at the HBM rate (about 10 FLOP an element against
    12 bytes)."""
    return tokens * add2_bytes_per_token(cfg) / PEAKS["hbm_bytes_s"]


def mlp_flop_per_token(cfg: dict) -> int:
    """fc1 and fc2 of every hybrid block and OCAB, per padded token:
    4 C hidden each, 10,886,400 at the published widths."""
    c = cfg["embed_dim"]
    return 4 * c * int(c * cfg["mlp_ratio"]) * (blocks(cfg) + groups(cfg))


def mlp_bound_s(cfg: dict, tokens: int) -> float:
    """Least seconds for the fused MLP launches over ``tokens`` padded
    tokens: the larger of the FLOP at the bf16 dense peak and the bytes
    (h read and y written, 2 C bf16 each, a block) at the HBM rate."""
    n = tokens * (blocks(cfg) + groups(cfg))
    return _bound_s(tokens * mlp_flop_per_token(cfg),
                    n * 4 * cfg["embed_dim"])
