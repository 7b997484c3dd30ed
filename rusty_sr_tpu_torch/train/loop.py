"""Training: Adam on the self-supervised pairs, on one device or
data-parallel over `torch.distributed`, one process per device.

The reference's `train` protocol as `rusty_sr_tpu/train/loop.py` runs it:

- The HR crop is the only input; the LR input is made inside the step
  (sRGB->linear -> fxf mean pool -> linear->sRGB), so a batch goes up
  once, as uint8.
- Loss: MSE (or L1) on the sRGB output, or on the linearised output with
  ``linear_loss``, plus 1/2 * 1e-6 * sum(w^2) over every parameter, in
  the loss itself so that the logged loss is the reference's.
- Adam(lr 2e-3, betas (0.95, 0.995), eps 1e-7), batch 4: torch's update
  is optax's m_hat / (sqrt(v_hat) + eps).
- Checkpoints (`.rsr` and a resumable torch checkpoint) and validation
  PSNR on independent cadences, both at step 1; the final parameters are
  written after the last step whatever the cadence; a 10 M sample
  budget.

Parameters and Adam's moments stay on the device; the loss comes back to
the host only at a cadence boundary.  On CUDA the whole step is one CUDA
graph (`GraphedStep`), replayed each step.  The float32 tier runs its forward
and backward passes inside `ops.conv.exact_f32`: autograd runs the
backward convolutions in ``loss.backward()``, outside any context the
forward entered, and cuDNN's default would run them in TF32.

Data-parallel (``group``, a process group already initialised; the
JAX package's 'data' mesh axis): each rank takes ``batch_size / world``
crops, and one all-reduce of a flat buffer — every gradient, the loss
and the mse — summed and divided by the world size makes each rank's
gradient that of the mean loss over the global batch.  Adam then runs
the same update on identical inputs everywhere, so the parameters stay
identical on every rank, bit for bit.  Rank 0 alone logs, validates and
writes the `.rsr`, the checkpoints and the metrics; every rank runs the
same steps, so none enters a collective that another skips.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from rusty_sr_tpu_torch import params as params_lib
from rusty_sr_tpu_torch.models.sr_net import (TRUNKS, SRNet, forward_fn,
                                              make_lr_from_hr)
from rusty_sr_tpu_torch.ops.color import srgb_to_linear
from rusty_sr_tpu_torch.ops.conv import exact_f32, tf32_on_bf16

@dataclasses.dataclass
class TrainConfig:
    factor: int = 3
    batch_size: int = 4            # src/main.rs:200
    crop: int = 192                # src/main.rs:187
    learning_rate: float = 2e-3    # src/main.rs:204
    beta1: float = 0.95            # src/main.rs:201
    beta2: float = 0.995           # src/main.rs:202
    epsilon: float = 1e-7          # src/main.rs:203
    l2_reg: float = 1e-6           # src/main.rs:185
    linear_loss: bool = False      # --linearLoss
    loss_kind: str = "mse"         # "mse" (the reference) or "l1"
    max_evals: int = 10_000_000    # sample budget, src/main.rs:253
    checkpoint_every: int = 100    # src/main.rs:211
    val_every: int = 100           # src/main.rs:233
    remat: bool = False            # recompute the forward in the backward
    steps_per_dispatch: int = 10   # batches uploaded at once; clamped so
    #                                that cadence boundaries stay exact
    trunk: str = "merged"          # "merged" (wide convA/B/C, merged in
    #                                the step), "flat" (the literal
    #                                topology) or "packed" (bf16 2x2
    #                                space-to-depth trunk)
    amp: bool = False              # bf16 conv operands, f32 sums, f32
    #                                parameters, Adam state and loss


def _check_config(cfg: TrainConfig) -> None:
    if cfg.trunk not in TRUNKS:
        raise ValueError(f"trunk must be one of {TRUNKS}, got {cfg.trunk!r}")


def loss_fn(params: dict, hr: torch.Tensor, cfg: TrainConfig):
    """(loss, mse) of a batch of HR crops (N,H,W,3), uint8 codes or
    float32 in [0,1]; ``params`` maps the reference names to tensors.

    uint8 batches are scaled by ``x.float() * (1/255)``, the multiply the
    host would do, so they give the float32 batches' loss.  With
    ``cfg.remat`` the forward pass is recomputed in the backward pass
    (`torch.utils.checkpoint`), which trades operations for memory."""
    _check_config(cfg)
    if hr.dtype == torch.uint8:
        hr = hr.float() * (1.0 / 255.0)
    lr = make_lr_from_hr(hr, cfg.factor)
    fwd = forward_fn(cfg.trunk, cfg.amp)
    if cfg.remat:
        from torch.utils.checkpoint import checkpoint
        # The forward draws no random numbers: no RNG state to keep (and
        # none may be read inside a CUDA graph's capture).
        out = checkpoint(fwd, params, lr, cfg.factor, use_reentrant=False,
                         preserve_rng_state=False)
    else:
        out = fwd(params, lr, cfg.factor)
    if cfg.linear_loss:
        a, b = srgb_to_linear(out), srgb_to_linear(hr)
    else:
        a, b = out, hr
    mse = torch.mean((a - b) ** 2)
    data_loss = torch.mean(torch.abs(a - b)) if cfg.loss_kind == "l1" \
        else mse
    if cfg.l2_reg:
        # The reference's L2Regularisation as 1/2 * coef * w^2 (gradient
        # coef * w), as the JAX package assumes it.
        reg = cfg.l2_reg * 0.5 * sum(torch.sum(w * w)
                                     for w in params.values())
        data_loss = data_loss + reg
    return data_loss, mse


def make_optimizer(cfg: TrainConfig, params: dict,
                   capturable: bool = False) -> torch.optim.Adam:
    """Adam over ``params`` (in their order) with the reference's
    hyperparameters; ``capturable`` keeps its step count on the device,
    so that a CUDA graph can hold the update (`GraphedStep`)."""
    return torch.optim.Adam(list(params.values()), lr=cfg.learning_rate,
                            betas=(cfg.beta1, cfg.beta2), eps=cfg.epsilon,
                            capturable=capturable)


def adam_state_from_numpy(params: dict, mu: dict, nu: dict, count,
                          cfg: Optional[TrainConfig] = None) -> dict:
    """optax's Adam state — the moments ``mu`` and ``nu`` as numpy trees
    keyed like ``params``, and its step ``count`` — as the state dict of
    `make_optimizer(cfg, params)`, to pass to its ``load_state_dict``."""
    opt = make_optimizer(cfg or TrainConfig(), params)
    for k, p in params.items():
        opt.state[p] = {
            "step": torch.tensor(float(np.asarray(count))),
            "exp_avg": torch.tensor(np.asarray(mu[k], np.float32),
                                    device=p.device),
            "exp_avg_sq": torch.tensor(np.asarray(nu[k], np.float32),
                                       device=p.device)}
    return opt.state_dict()


def step_precision(cfg: TrainConfig):
    """The convolution precision of a training step, forward and backward:
    exact float32 (TF32 off) for the float32 tiers; for the bf16 tiers
    (``amp`` or the packed trunk), TF32 allowed, which holds their
    bfloat16 operands exactly."""
    bf16 = cfg.amp or cfg.trunk == "packed"
    return tf32_on_bf16() if bf16 else exact_f32()


def world_of(group) -> tuple:
    """(rank, world size) of a process group; (0, 1) for None."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _pack(params: dict, loss, mse, flat: torch.Tensor) -> None:
    """Every gradient, then the loss and the mse, into ``flat``."""
    off = 0
    for p in params.values():
        flat[off:off + p.numel()].copy_(p.grad.reshape(-1))
        off += p.numel()
    flat[off].copy_(loss.detach())
    flat[off + 1].copy_(mse.detach())


def _unpack(flat: torch.Tensor, params: dict, world: int):
    """``flat`` (summed over the ranks) divided by ``world``, written back
    into the gradients; returns views of its (loss, mse)."""
    flat.div_(world)
    off = 0
    for p in params.values():
        p.grad.copy_(flat[off:off + p.numel()].view_as(p.grad))
        off += p.numel()
    return flat[off], flat[off + 1]


def _flat_buffer(params: dict) -> torch.Tensor:
    p0 = next(iter(params.values()))
    n = sum(p.numel() for p in params.values())
    return torch.empty(n + 2, dtype=torch.float32, device=p0.device)


def train_step(params: dict, opt: torch.optim.Optimizer, hr: torch.Tensor,
               cfg: TrainConfig, group=None):
    """One optimizer step on the batch ``hr`` (on the parameters'
    device); returns (loss, mse) as device tensors, unsynchronised.  With
    a process ``group``, the gradients, loss and mse are averaged over
    its ranks by one all-reduce before Adam's update."""
    opt.zero_grad(set_to_none=True)
    with step_precision(cfg):
        loss, mse = loss_fn(params, hr, cfg)
        loss.backward()
    if group is not None:
        flat = _flat_buffer(params)
        _pack(params, loss, mse, flat)
        dist.all_reduce(flat, group=group)
        loss, mse = (t.clone() for t in _unpack(flat, params,
                                                world_of(group)[1]))
    opt.step()
    return loss.detach(), mse.detach()


class GraphedStep:
    """`train_step` captured in one CUDA graph — forward, backward and
    Adam (``capturable=True``) — and replayed on a static batch buffer:
    an eager step issues ~450 small launches, and at batch 4 the host's
    time to issue them is most of the step (PERF.md §5).

    The graph is captured at the first call, and again when the batch's
    shape or type changes.  Capture follows three warm-up steps on a side
    stream (they allocate Adam's state and settle cuDNN's choices) on the
    batch given; the parameters and Adam's state are then put back, so
    the first replay is the step the caller asked for.  The returned loss
    and mse are copies: the graph's own outputs are overwritten by the
    next replay.  After a call, each parameter's ``.grad`` holds that
    step's gradient.

    With a process ``group`` the step is two graphs and a collective
    between them: forward and backward packing the gradients, loss and
    mse into a static flat buffer; the all-reduce of that buffer, outside
    any graph (gloo's cannot be captured, and NCCL's would need its
    warm-up outside the capture); then the division and Adam.  The
    warm-up steps run the eager data-parallel step, so every rank makes
    the same collectives in the same order."""

    WARMUP = 3

    def __init__(self, params: dict, opt: torch.optim.Optimizer,
                 cfg: TrainConfig, group=None):
        self.params, self.opt, self.cfg = params, opt, cfg
        self.group = group
        self.key = None

    def _capture(self, hr: torch.Tensor) -> None:
        p, opt = self.params, self.opt
        with torch.no_grad():
            kept_p = [(v, v.clone()) for v in p.values()]
            kept_st = [(t, t.clone()) for st in opt.state.values()
                       for t in st.values() if torch.is_tensor(t)]
        self.x = hr.clone()
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for _ in range(self.WARMUP):
                train_step(p, opt, self.x, self.cfg, self.group)
        main.wait_stream(side)
        opt.zero_grad(set_to_none=True)
        if self.group is None:
            self.graphs = [torch.cuda.CUDAGraph()]
            with torch.cuda.graph(self.graphs[0]):
                self.loss, self.mse = train_step(p, opt, self.x, self.cfg)
        else:
            # Another thread (a collective's watchdog) may query the
            # device while a stream captures.
            torch.cuda.synchronize()
            self.flat = _flat_buffer(p)
            self.graphs = [torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()]
            with torch.cuda.graph(self.graphs[0],
                                  capture_error_mode="thread_local"):
                with step_precision(self.cfg):
                    loss, mse = loss_fn(p, self.x, self.cfg)
                    loss.backward()
                _pack(p, loss, mse, self.flat)
            with torch.cuda.graph(self.graphs[1],
                                  capture_error_mode="thread_local"):
                self.loss, self.mse = _unpack(self.flat, p,
                                              world_of(self.group)[1])
                opt.step()
        kept = {id(t) for t, _ in kept_st}
        with torch.no_grad():
            for t, v in kept_p + kept_st:
                t.copy_(v)
            for st in opt.state.values():       # state the warm-up made
                for t in st.values():
                    if torch.is_tensor(t) and id(t) not in kept:
                        t.zero_()

    def __call__(self, hr: torch.Tensor):
        key = (tuple(hr.shape), hr.dtype)
        if key != self.key:
            self._capture(hr)
            self.key = key
        self.x.copy_(hr)
        self.graphs[0].replay()
        if self.group is not None:
            dist.all_reduce(self.flat, group=self.group)
            self.graphs[1].replay()
        return self.loss.clone(), self.mse.clone()


def make_train_step(cfg: TrainConfig, params: dict, group=None):
    """(step, opt): ``step(hr) -> (loss, mse)`` takes one Adam step over
    ``params`` on the batch ``hr`` (on their device), ``opt`` being that
    Adam; with a process ``group``, data-parallel over its ranks.  On
    CUDA the step is a `GraphedStep`; on the CPU, `train_step`."""
    cuda = next(iter(params.values())).is_cuda
    opt = make_optimizer(cfg, params, capturable=cuda)
    if cuda:
        return GraphedStep(params, opt, cfg, group), opt
    if group is None:
        return (lambda hr: train_step(params, opt, hr, cfg)), opt
    return (lambda hr: train_step(params, opt, hr, cfg, group)), opt


def train_steps(step, hrs: torch.Tensor):
    """``len(hrs)`` calls of ``step`` over the batches ``hrs`` (n, N, H, W,
    3), one upload for all of them; returns the last (loss, mse)."""
    for hr in hrs:
        loss, mse = step(hr)
    return loss, mse


class _Uploader:
    """Host batches to the device: on CUDA through a ring of pinned
    buffers, copied with ``non_blocking=True``.  A buffer is refilled only
    after the event recorded behind its last copy, so the host never
    writes a buffer that a copy still reads; on the CPU a batch is used as
    it is."""

    SLOTS = 3

    def __init__(self, device: torch.device):
        self.device = device
        self.rings: dict = {}     # (shape, dtype) -> [(pinned, event)]
        self.k = 0

    def __call__(self, arr: np.ndarray) -> torch.Tensor:
        arr = np.ascontiguousarray(arr)
        if self.device.type != "cuda":
            return torch.from_numpy(arr)
        ring = self.rings.setdefault((arr.shape, arr.dtype.str), [])
        if len(ring) < self.SLOTS:
            ring.append((torch.empty(arr.shape,
                                     dtype=torch.from_numpy(arr[:0]).dtype,
                                     pin_memory=True), torch.cuda.Event()))
            buf, ev = ring[-1]
        else:
            buf, ev = ring[self.k % self.SLOTS]
            ev.synchronize()
        self.k += 1
        buf.numpy()[...] = arr
        t = buf.to(self.device, non_blocking=True)
        ev.record()
        return t


def _np_srgb_to_linear(x: np.ndarray) -> np.ndarray:
    return np.where(x <= 0.04045, x / 12.92,
                    ((x + 0.055) / 1.055) ** 2.4).astype(np.float32)


def _np_linear_to_srgb(x: np.ndarray) -> np.ndarray:
    return np.where(x <= 0.0031308, 12.92 * x,
                    1.055 * np.maximum(x, 0.0) ** (1 / 2.4) - 0.055
                    ).astype(np.float32)


def _np_make_lr(hr: np.ndarray, f: int) -> np.ndarray:
    """Host-side pair synthesis for validation images of any shape (the
    JAX package's `_np_make_lr`, the same numpy arithmetic)."""
    lin = _np_srgb_to_linear(np.asarray(hr, np.float32))
    h, w, c = lin.shape
    lin = lin.reshape(h // f, f, w // f, f, c).mean(axis=(1, 3))
    return _np_linear_to_srgb(lin)


def validation_psnr(params, val_images, cfg: TrainConfig, tile: int = 242,
                    device="cuda") -> float:
    """Pixel-weighted validation PSNR over whole images
    (src/main.rs:231-250): -10*log10(sum(err*px)/sum(px)).

    Each image, cropped to a multiple of the factor, is downsampled on the
    host and upscaled by `parallel.tiling.tiled_sr`'s exact tier on
    ``device`` (on the card: cuDNN's float32 convolutions and the
    epilogue kernel, float32 out).  ``params``: a numpy tree."""
    from rusty_sr_tpu_torch.parallel.tiling import tiled_sr

    err_sum, pix_sum = 0.0, 0.0
    f = cfg.factor
    for hr in val_images:
        hr = np.asarray(hr, np.float32)
        h, w, _ = hr.shape
        hr = hr[: h - h % f, : w - w % f]
        lr = _np_make_lr(hr, f)
        out = tiled_sr(params, lr, f, tile=tile, chunk=4, device=device)
        if cfg.linear_loss:
            a, b = _np_srgb_to_linear(out), _np_srgb_to_linear(hr)
        else:
            a, b = out, hr
        mse = float(np.mean((a - b) ** 2))
        px = hr.shape[0] * hr.shape[1]
        err_sum += mse * px
        pix_sum += px
    return -10.0 * math.log10(max(err_sum / pix_sum, 1e-300))


def _dispatch_group(cfg: TrainConfig, validate: bool) -> int:
    """Steps per upload group: at most ``steps_per_dispatch`` and a
    divisor of every cadence (checkpoint, and validation when active), so
    each boundary lands at the end of a group."""
    cad = cfg.checkpoint_every
    if validate:
        cad = math.gcd(cad, cfg.val_every)
    spd = max(1, min(cfg.steps_per_dispatch, cad))
    while cad % spd:
        spd -= 1
    return spd


def _resume(resume_from: str, native_ckpt_dir: Optional[str], model: SRNet,
            opt: torch.optim.Optimizer, log) -> int:
    """Load the checkpoint ``resume_from`` (a ``step_*`` file, or a folder
    of them: the latest) into ``model`` and ``opt``; returns its step (0
    where a folder holds none yet)."""
    import re
    from rusty_sr_tpu_torch.train import checkpoint as _ck

    path = _ck.latest_native(resume_from)
    if path is None and os.path.isfile(resume_from) and re.fullmatch(
            r"step_\d+", os.path.basename(resume_from)):
        path = resume_from
    is_own = native_ckpt_dir is not None and \
        os.path.realpath(resume_from) == os.path.realpath(native_ckpt_dir)
    if path is None:
        if os.path.isdir(resume_from) or is_own:
            # A wrapper that always passes --resume starts fresh on its
            # first launch.
            log(f"No checkpoint under {resume_from!r} yet — starting fresh")
            return 0
        raise RuntimeError(f"no native checkpoint found at {resume_from!r}")
    try:
        has_opt = "opt_state" in _ck.checkpoint_keys(path)
    except Exception as e:
        raise RuntimeError(f"unreadable checkpoint at {path!r}: {e}") from e
    if not has_opt:
        log(f"Checkpoint {path} has no optimizer state — resuming with "
            "fresh Adam moments")
    try:
        tree, opt_state, step = _ck.restore_native(path, model.tree())
        if opt_state is not None:
            _ck.check_adam_state(opt_state, model.tree())
            own = [g["capturable"] for g in opt.param_groups]
            opt.load_state_dict(opt_state)
            for g, c in zip(opt.param_groups, own):   # the device decides
                g["capturable"] = c
    except (ValueError, KeyError, TypeError, IndexError,
            AttributeError) as e:
        raise RuntimeError(f"incompatible or unreadable checkpoint at "
                           f"{path!r}: {e}") from e
    with torch.no_grad():
        for k, p in model.params().items():
            p.copy_(torch.from_numpy(tree[k]))
    log(f"Resumed from {path} at step {step}")
    return step


def train_loop(cfg: TrainConfig, train_batches, *, start_params=None,
               param_file: Optional[str] = None,
               val_images: Optional[list] = None,
               log: Callable[[str], None] = print,
               max_steps: Optional[int] = None,
               metrics_file: Optional[str] = None,
               native_ckpt_dir: Optional[str] = None,
               resume_from: Optional[str] = None,
               validate: Optional[bool] = None,
               seed: int = 0, device="cuda", group=None) -> dict:
    """Run the reference's training protocol on ``device``; returns the
    final parameters as a numpy tree.

    ``train_batches`` yields (N,crop,crop,3) HR batches, uint8 or float32
    (host numpy).  ``metrics_file``: JSONL records (step, loss, mse,
    validation PSNR, wall time) at each cadence boundary.
    ``native_ckpt_dir``: resumable checkpoints (parameters, Adam state,
    step) at the checkpoint cadence and after the last step.
    ``resume_from``: such a checkpoint, or a folder of them (the latest),
    restoring parameters, Adam state and the step counter; a folder with
    none yet starts fresh.  ``validate``: whether the validation cadence
    is active (default: ``bool(val_images)``).

    ``group``: an initialised `torch.distributed` process group to train
    data-parallel over, this process being one rank on ``device``.  Each
    rank's ``train_batches`` yields its ``cfg.batch_size / world`` crops
    and the same number of batches; every rank starts from the same
    parameters (``start_params``, ``seed`` or ``resume_from``, read on
    each) and passes the same ``validate``.  Rank 0 alone logs,
    validates and writes ``param_file``, ``metrics_file`` and the
    checkpoints; the ranks return together, after its last write."""
    _check_config(cfg)
    device = torch.device(device)
    rank, world = world_of(group)
    if cfg.batch_size % world:
        raise ValueError(f"batch size {cfg.batch_size} does not divide "
                         f"over {world} processes")
    if validate is None:
        validate = bool(val_images)
    if rank != 0:
        param_file = metrics_file = val_images = None

        def log(_msg):
            pass
    tree = start_params if start_params is not None else \
        params_lib.init_params(seed, cfg.factor)
    model = SRNet(tree, cfg.factor, cfg.trunk, cfg.amp).to(device)
    step_fn, opt = make_train_step(cfg, model.params(), group)
    start_step = 0
    if resume_from is not None:
        start_step = _resume(resume_from, native_ckpt_dir, model, opt, log)

    budget_steps = cfg.max_evals // cfg.batch_size
    if max_steps is not None:
        budget_steps = min(budget_steps, max_steps)
    upload = _Uploader(device)
    mf = open(metrics_file, "a") if metrics_file else None
    t_start = time.time()
    step = start_step
    last_native_ckpt = last_rsr_ckpt = start_step

    def cadence(step, loss, mse):
        nonlocal last_native_ckpt, last_rsr_ckpt
        do_ckpt = step % cfg.checkpoint_every == 0 or step == 1
        do_val = validate and (step % cfg.val_every == 0 or step == 1)
        if rank != 0 or not (do_ckpt or do_val):
            return
        host = model.tree()
        if do_ckpt and param_file is not None:
            params_lib.save_rsr_file(param_file, host, cfg.factor)
            last_rsr_ckpt = step
        if do_ckpt and native_ckpt_dir is not None:
            from rusty_sr_tpu_torch.train import checkpoint as _ck
            _ck.save_native(native_ckpt_dir, step, host, opt.state_dict())
            last_native_ckpt = step
        psnr = None
        if do_val and val_images:
            psnr = validation_psnr(host, val_images, cfg, device=device)
            log(f"Validation PSNR:\t{psnr}")
        elif do_ckpt:
            log(f"step {step}\tloss {float(loss):.6g}\tmse {float(mse):.6g}")
        if mf is not None:
            rec = {"step": step, "loss": float(loss), "mse": float(mse),
                   "wall_s": time.time() - t_start}
            if psnr is not None:
                rec["val_psnr"] = psnr
            mf.write(json.dumps(rec) + "\n")
            mf.flush()

    spd = _dispatch_group(cfg, validate)
    it = iter(train_batches)
    try:
        while step < budget_steps:
            n_up = spd if (spd > 1 and step >= 1 and step % spd == 0
                            and budget_steps - step >= spd) else 1
            batches = []
            for _ in range(n_up):
                hr = next(it, None)
                if hr is None:
                    break
                batches.append(hr)
            if len(batches) == spd and n_up == spd and spd > 1:
                loss, mse = train_steps(step_fn, upload(np.stack(batches)))
                step += spd
                cadence(step, loss, mse)
            else:
                for hr in batches:
                    step += 1
                    loss, mse = step_fn(upload(hr))
                    cadence(step, loss, mse)
            if not batches or len(batches) < n_up:
                break   # the input stream ended
    finally:
        if mf is not None:
            mf.close()
    host = model.tree()
    if param_file is not None and step > last_rsr_ckpt:
        # The final parameters, whatever the cadence.
        params_lib.save_rsr_file(param_file, host, cfg.factor)
    if rank == 0 and native_ckpt_dir is not None and step > last_native_ckpt:
        from rusty_sr_tpu_torch.train import checkpoint as _ck
        _ck.save_native(native_ckpt_dir, step, host, opt.state_dict())
    if group is not None:
        # No rank returns before rank 0's last write.
        nccl = dist.get_backend(group) == "nccl"
        dist.barrier(group=group, device_ids=[
            torch.cuda.current_device() if device.index is None
            else device.index] if nccl else None)
    return host
