"""Training: Adam on the self-supervised pairs, on one device or over a
(data, spatial, model) mesh of processes under `torch.distributed`, one
process per device.

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
graph (`GraphedStep`), replayed each step.  The float32 tiers run their
forward and backward passes inside `ops.conv.exact_f32`: autograd runs
the backward convolutions in ``loss.backward()``, outside any context
the forward entered, and cuDNN's default would run them in TF32.
``precision="high"`` (the JAX package's ``Precision.HIGH``) runs every
convolution of the float32 tiers, forward and backward, as the
three-term bf16 split (`ops.conv.conv2d_bf16x3`), which alone allows
TF32 around its own products.

On a mesh (``group``, a process group already initialised, with
``n_spatial`` and ``n_model``; `parallel.mesh.RankGrid`): each rank
takes its data index's ``batch_size / n_data`` crops; on a spatial axis
it computes its share of the crops' rows with a halo from the crop
itself, so its forward pass needs no collective (`loss_fn`); each
rank's loss is its share of the global loss, and one all-reduce of a
flat buffer over the data and spatial axes — every gradient, the loss
and the mse — sums them into the gradient of the global mean (in the
bf16 tiers the convolution weights' gradients are summed in float32 and
rounded to bfloat16 once, after the sum, as one process rounds them
once: `bf16_grad_leaves`).  On a
model axis each rank's Adam holds its `tp_spec` shard of every
parameter and moment, and the full parameters are gathered over the
axis before each step (`_GridState`).  Every rank thus makes the same
update to the same values, and the ranks' parameters stay identical,
bit for bit.  Rank 0 alone logs, validates and writes the `.rsr`, the
checkpoints and the metrics; every rank runs the same steps and
gathers, so none enters a collective that another skips.
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
from rusty_sr_tpu_torch.models.sr_net import (PRECISIONS, TRUNKS, SRNet,
                                              forward_fn, make_lr_from_hr)
from rusty_sr_tpu_torch.ops.color import srgb_to_linear
from rusty_sr_tpu_torch.ops.conv import exact_f32, tf32_on_bf16
from rusty_sr_tpu_torch.parallel.mesh import (RankGrid, grid_coords, rows,
                                              shard_of, tp_spec)


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
    precision: str = "highest"     # the f32 tiers' convolutions: "highest"
    #                                (exact) or "high" (the three-term
    #                                bf16 split, ops.conv.conv2d_bf16x3);
    #                                ignored under amp and the packed trunk


def _check_config(cfg: TrainConfig) -> None:
    if cfg.trunk not in TRUNKS:
        raise ValueError(f"trunk must be one of {TRUNKS}, got {cfg.trunk!r}")
    if cfg.precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{cfg.precision!r}")


def loss_fn(params: dict, hr: torch.Tensor, cfg: TrainConfig, grid=None):
    """(loss, mse) of a batch of HR crops (N,H,W,3), uint8 codes or
    float32 in [0,1]; ``params`` maps the reference names to tensors.

    uint8 batches are scaled by ``x.float() * (1/255)``, the multiply the
    host would do, so they give the float32 batches' loss.  With
    ``cfg.remat`` the forward pass is recomputed in the backward pass
    (`torch.utils.checkpoint`), which trades operations for memory.

    ``grid`` (a `parallel.mesh.RankGrid`: its ``shape`` and ``coords``):
    ``hr`` is this rank's data index's share of the global batch, and the
    result is this rank's share of the global loss, so that the sum over
    the data and spatial axes is the global loss.  The rank computes its
    spatial index's LR rows of the crops (`parallel.mesh.rows`, in row
    pairs for the packed trunk) with `HALO_T` more on each side, straight
    from the HR crop; the data term covers its own rows, scaled by their
    share of the global batch's pixels; the L2 term is divided by the
    ranks that sum it."""
    _check_config(cfg)
    share = None
    if grid is not None:
        f, nd, ns = cfg.factor, grid.shape["data"], grid.shape["spatial"]
        h = hr.shape[1] // f
        lo, hi, wlo, whi = rows(h, ns, grid.coords["spatial"],
                                2 if cfg.trunk == "packed" else 1)
        hr = hr[:, f * wlo:f * whi]
        share = (f * (lo - wlo), f * (hi - wlo), (hi - lo) / (h * nd),
                 1.0 / (nd * ns))
    if hr.dtype == torch.uint8:
        hr = hr.float() * (1.0 / 255.0)
    lr = make_lr_from_hr(hr, cfg.factor)
    fwd = forward_fn(cfg.trunk, cfg.amp, cfg.precision)
    if cfg.remat:
        from torch.utils.checkpoint import checkpoint
        # The forward draws no random numbers: no RNG state to keep (and
        # none may be read inside a CUDA graph's capture).
        out = checkpoint(fwd, params, lr, cfg.factor, use_reentrant=False,
                         preserve_rng_state=False)
    else:
        out = fwd(params, lr, cfg.factor)
    if share is not None:
        out, hr = out[:, share[0]:share[1]], hr[:, share[0]:share[1]]
    if cfg.linear_loss:
        a, b = srgb_to_linear(out), srgb_to_linear(hr)
    else:
        a, b = out, hr
    mse = torch.mean((a - b) ** 2)
    data_loss = torch.mean(torch.abs(a - b)) if cfg.loss_kind == "l1" \
        else mse
    if share is not None:
        data_loss, mse = data_loss * share[2], mse * share[2]
    if cfg.l2_reg:
        # The reference's L2Regularisation as 1/2 * coef * w^2 (gradient
        # coef * w), as the JAX package assumes it.
        reg = cfg.l2_reg * 0.5 * sum(torch.sum(w * w)
                                     for w in params.values())
        data_loss = data_loss + (reg if share is None else reg * share[3])
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
    exact float32 (TF32 off) for the float32 tiers, ``precision="high"``
    included (its split convolutions allow TF32 around themselves alone,
    `ops.conv.conv2d_bf16x3`); for the bf16 tiers (``amp`` or the packed
    trunk), TF32 allowed, which holds their bfloat16 operands exactly."""
    bf16 = cfg.amp or cfg.trunk == "packed"
    return tf32_on_bf16() if bf16 else exact_f32()


def bf16_grad_leaves(cfg: TrainConfig, names) -> tuple:
    """The leaves whose gradient a step rounds to bfloat16, once: in the
    bf16 tiers (``amp``, the packed trunk) the convolution weights, whose
    convolutions return their gradient unrounded in float32
    (`ops.conv.conv2d_bf16`).  One process rounds the whole gradient; a
    mesh rounds the sum of the ranks' parts, after the all-reduce, which
    is the same rounding point."""
    if not (cfg.amp or cfg.trunk == "packed"):
        return ()
    return tuple(k for k in names if k.startswith("conv"))


def _round_to_bf16_(grads) -> None:
    """Round each gradient to bfloat16 in place (its values; the tensor
    stays float32)."""
    with torch.no_grad():
        for g in grads:
            g.copy_(g.to(torch.bfloat16))


def world_of(group) -> tuple:
    """(rank, world size) of a process group; (0, 1) for None."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


class _GridState:
    """One rank's train state on a mesh of processes (`RankGrid`).

    ``full`` are the parameters the forward pass reads, whole on every
    rank; ``held`` the tensors this rank's Adam updates: each leaf
    whole, or under a model axis its `tp_spec` shard (a tensor of its
    own, whose ``.grad`` is allocated here).  Two flat buffers carry the
    collectives: ``flat`` (every held gradient, then the loss and the
    mse), summed over ``grid.reduce_group``; under a model axis ``gbuf``
    (every leaf in its full layout, zero but for this rank's shards and,
    on model rank 0, the replicated leaves), summed over
    ``grid.model_group``, which gathers them.  ``rounded`` names the
    leaves whose summed gradient `unpack` rounds to bfloat16
    (`bf16_grad_leaves`).  The replicated leaves
    travel too: each model rank computes their gradient on its own, and
    two processes' convolutions need not agree to the last bit (cuDNN's
    weight gradients on the card), so model rank 0's values are the
    ones every rank loads."""

    def __init__(self, params: dict, grid, rounded=()):
        self.full, self.grid, self.rounded = params, grid, tuple(rounded)
        nm, self.m = grid.shape["model"], grid.coords["model"]
        self.nm = nm
        self.sharded = [k for k, v in params.items()
                        if nm > 1 and tp_spec(v, nm)]
        self.gathered = list(params) if nm > 1 else []
        self.held = dict(params)
        with torch.no_grad():
            for k in self.sharded:
                h = shard_of(params[k].detach(), nm, self.m).clone(
                    memory_format=torch.contiguous_format)
                h.requires_grad_(True)
                h.grad = torch.zeros_like(h)
                self.held[k] = h
        p0 = next(iter(params.values()))
        n = sum(h.numel() for h in self.held.values())
        self.flat = torch.empty(n + 2, dtype=torch.float32, device=p0.device)
        self.gbuf = torch.empty(sum(params[k].numel()
                                    for k in self.gathered),
                                dtype=torch.float32, device=p0.device)
        self.publish()

    def _views(self, buf) -> dict:
        views, off = {}, 0
        for k in self.gathered:
            n = self.full[k].numel()
            views[k] = buf[off:off + n].view(self.full[k].shape)
            off += n
        return views

    def _own(self, t):
        return shard_of(t, self.nm, self.m)

    def publish(self, buf=None) -> None:
        """This rank's shards (on model rank 0 also the replicated leaves)
        into ``buf`` (default ``gbuf``), zero elsewhere."""
        buf = self.gbuf if buf is None else buf
        with torch.no_grad():
            buf.zero_()
            for k, v in self._views(buf).items():
                if k in self.sharded:
                    self._own(v).copy_(self.held[k])
                elif self.m == 0:
                    v.copy_(self.held[k])

    def gather(self, buf=None) -> None:
        """Collective over the model axis: sum ``buf`` (default ``gbuf``),
        which assembles the full leaves."""
        if self.gathered:
            dist.all_reduce(self.gbuf if buf is None else buf,
                            group=self.grid.model_group)

    def load_full(self, buf=None) -> None:
        with torch.no_grad():
            for k, v in self._views(self.gbuf if buf is None
                                    else buf).items():
                self.full[k].copy_(v)

    def sync(self) -> None:
        """Collective over the model axis: bring ``full`` up to date with
        every rank's shards (after a step they are a step behind)."""
        if self.gathered:
            buf = torch.empty_like(self.gbuf)
            self.publish(buf)
            self.gather(buf)
            self.load_full(buf)

    def reshard(self) -> None:
        """``held`` from ``full`` (after a checkpoint's parameters were
        loaded into it), and ``gbuf`` from them."""
        with torch.no_grad():
            for k in self.sharded:
                self.held[k].copy_(self._own(self.full[k]))
        self.publish()

    def pack(self, loss, mse) -> None:
        """This rank's part of every gradient, then the loss and the mse,
        into ``flat``.  Every model rank ran the same forward on the same
        rows, so each full gradient is already the whole of it: a slice,
        never a sum over the model axis."""
        off = 0
        for k, h in self.held.items():
            g = self.full[k].grad
            self.flat[off:off + h.numel()].view(h.shape).copy_(
                self._own(g) if k in self.sharded else g)
            off += h.numel()
        self.flat[off].copy_(loss.detach())
        self.flat[off + 1].copy_(mse.detach())

    def reduce(self) -> None:
        """Collective over the data and spatial axes: sum ``flat``.  Each
        rank's loss is its share of the global loss (`loss_fn`), so the
        sum is the global loss and its gradient."""
        if self.grid.reduce_group is not None:
            dist.all_reduce(self.flat, group=self.grid.reduce_group)

    def unpack(self) -> tuple:
        """``flat`` into the held tensors' gradients, the ``rounded`` ones
        rounded to bfloat16 after the sum; views of its (loss, mse)."""
        off = 0
        for h in self.held.values():
            h.grad.copy_(self.flat[off:off + h.numel()].view_as(h))
            off += h.numel()
        _round_to_bf16_(self.held[k].grad for k in self.rounded)
        return self.flat[off], self.flat[off + 1]

    def forward_backward(self, hr, cfg) -> None:
        for p in self.full.values():
            p.grad = None
        with step_precision(cfg):
            loss, mse = loss_fn(self.full, hr, cfg, self.grid)
            loss.backward()
        self.pack(loss, mse)

    def full_opt_state(self, opt) -> dict:
        """Collective over the model axis: Adam's ``state_dict`` in the
        unsharded layout (each sharded leaf's moments gathered), as a
        checkpoint stores it."""
        sd = opt.state_dict()
        if not self.sharded:
            return sd
        # state_dict() shares the optimizer's own per-parameter dicts
        sd["state"] = {i: dict(st) for i, st in sd["state"].items()}
        names = list(self.held)
        bufs = {key: torch.empty_like(self.gbuf)
                for key in ("exp_avg", "exp_avg_sq")}
        for key, buf in bufs.items():
            buf.zero_()
            views = self._views(buf)
            for i, st in sd["state"].items():
                if names[i] in self.sharded:
                    self._own(views[names[i]]).copy_(st[key])
            self.gather(buf)
        for i, st in sd["state"].items():
            if names[i] in self.sharded:
                for key, buf in bufs.items():
                    st[key] = self._views(buf)[names[i]].clone()
        return sd

    def load_opt_state(self, opt, sd: dict) -> None:
        """Adam's state from ``sd`` (the unsharded layout), this rank's
        shard of each sharded leaf's moments."""
        names = list(self.held)
        own = {"state": {i: {key: (self._own(v) if torch.is_tensor(v)
                                   and names[int(i)] in self.sharded
                                   and key != "step" else v)
                             for key, v in st.items()}
                         for i, st in sd["state"].items()},
               "param_groups": sd["param_groups"]}
        opt.load_state_dict(own)


def _grid_step(st: _GridState, opt, hr, cfg: TrainConfig):
    """One eager step of a rank on a mesh: gather, forward and backward,
    the reduction, Adam on the held tensors."""
    st.gather()
    st.load_full()
    st.forward_backward(hr, cfg)
    st.reduce()
    loss, mse = st.unpack()
    opt.step()
    st.publish()
    return loss.clone(), mse.clone()


def train_step(params: dict, opt: torch.optim.Optimizer, hr: torch.Tensor,
               cfg: TrainConfig, group=None):
    """One optimizer step on the batch ``hr`` (on the parameters'
    device); returns (loss, mse) as device tensors, unsynchronised.  With
    a process ``group``, data-parallel over its ranks: each rank's loss
    is its share of the global batch's (`loss_fn`), and one all-reduce
    sums the gradients, loss and mse before Adam's update."""
    if group is not None:
        return _grid_step(_GridState(params, RankGrid(group),
                                     bf16_grad_leaves(cfg, params)),
                          opt, hr, cfg)
    opt.zero_grad(set_to_none=True)
    with step_precision(cfg):
        loss, mse = loss_fn(params, hr, cfg)
        loss.backward()
    _round_to_bf16_(params[k].grad for k in bf16_grad_leaves(cfg, params))
    opt.step()
    return loss.detach(), mse.detach()


class _EagerStep:
    """The step on the CPU: `train_step`, or on a mesh `_grid_step` over
    ``state``."""

    def __init__(self, params: dict, opt, cfg: TrainConfig, state=None):
        self.params, self.opt, self.cfg, self.state = params, opt, cfg, state

    def __call__(self, hr: torch.Tensor):
        if self.state is None:
            return train_step(self.params, self.opt, hr, self.cfg)
        return _grid_step(self.state, self.opt, hr, self.cfg)


class GraphedStep(_EagerStep):
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

    On a mesh (``state``, a `_GridState`) the step is two graphs with the
    collectives outside them (gloo's cannot be captured, and NCCL's would
    need its warm-up outside the capture): the model axis's gather of
    the parameters; graph 0, which loads them, runs forward and backward
    and packs this rank's gradients, loss and mse into a static flat
    buffer; the all-reduce of that buffer; graph 1, which unpacks it,
    runs Adam on the held tensors and publishes this rank's shards for
    the next gather.  The warm-up steps run the eager mesh step, so every
    rank makes the same collectives in the same order."""

    WARMUP = 3

    def __init__(self, params: dict, opt: torch.optim.Optimizer,
                 cfg: TrainConfig, state=None):
        super().__init__(params, opt, cfg, state)
        self.key = None

    def _capture(self, hr: torch.Tensor) -> None:
        p, opt, st = self.params, self.opt, self.state
        live = dict(p) if st is None else {**p, **{
            "held." + k: v for k, v in st.held.items()}}
        with torch.no_grad():
            kept_p = [(v, v.clone()) for v in live.values()]
            kept_st = [(t, t.clone()) for s in opt.state.values()
                       for t in s.values() if torch.is_tensor(t)]
        self.x = hr.clone()
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for _ in range(self.WARMUP):
                _EagerStep.__call__(self, self.x)
        main.wait_stream(side)
        if st is None:
            opt.zero_grad(set_to_none=True)
            self.graphs = [torch.cuda.CUDAGraph()]
            with torch.cuda.graph(self.graphs[0]):
                self.loss, self.mse = train_step(p, opt, self.x, self.cfg)
        else:
            # Another thread (a collective's watchdog) may query the
            # device while a stream captures.
            torch.cuda.synchronize()
            self.graphs = [torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()]
            with torch.cuda.graph(self.graphs[0],
                                  capture_error_mode="thread_local"):
                st.load_full()
                st.forward_backward(self.x, self.cfg)
            with torch.cuda.graph(self.graphs[1],
                                  capture_error_mode="thread_local"):
                self.loss, self.mse = st.unpack()
                opt.step()
                st.publish()
        kept = {id(t) for t, _ in kept_st}
        with torch.no_grad():
            for t, v in kept_p + kept_st:
                t.copy_(v)
            for s in opt.state.values():        # state the warm-up made
                for t in s.values():
                    if torch.is_tensor(t) and id(t) not in kept:
                        t.zero_()
        if st is not None:
            st.publish()

    def __call__(self, hr: torch.Tensor):
        key = (tuple(hr.shape), hr.dtype)
        if key != self.key:
            self._capture(hr)
            self.key = key
        st = self.state
        if st is not None:
            st.gather()
        self.x.copy_(hr)
        self.graphs[0].replay()
        if st is not None:
            st.reduce()
            self.graphs[1].replay()
        return self.loss.clone(), self.mse.clone()


def make_train_step(cfg: TrainConfig, params: dict, group=None,
                    n_spatial: int = 1, n_model: int = 1):
    """(step, opt): ``step(hr) -> (loss, mse)`` takes one Adam step over
    ``params`` on the batch ``hr`` (on their device), ``opt`` being that
    Adam.  With a process ``group``, this process is one rank of a
    (data, spatial, model) mesh of its ranks (`parallel.mesh.RankGrid`,
    built here: every rank calls this at the same point), and ``hr`` is
    its data index's share of the global batch, whole crops; under a
    model axis ``opt`` updates this rank's shards (``step.state.held``).
    On CUDA the step is a `GraphedStep`; on the CPU, the eager step."""
    cuda = next(iter(params.values())).is_cuda
    state = None
    if group is not None:
        state = _GridState(params, RankGrid(group, n_spatial, n_model),
                           bf16_grad_leaves(cfg, params))
    held = params if state is None else state.held
    opt = make_optimizer(cfg, held, capturable=cuda)
    return (GraphedStep if cuda else _EagerStep)(params, opt, cfg,
                                                 state), opt


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
            opt: torch.optim.Optimizer, log, state=None) -> int:
    """Load the checkpoint ``resume_from`` (a ``step_*`` file, or a folder
    of them: the latest) into ``model`` and ``opt`` (on a mesh, through
    ``state``: this rank's shards); returns its step (0 where a folder
    holds none yet)."""
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
            if state is None:
                opt.load_state_dict(opt_state)
            else:
                state.load_opt_state(opt, opt_state)
            for g, c in zip(opt.param_groups, own):   # the device decides
                g["capturable"] = c
    except (ValueError, KeyError, TypeError, IndexError,
            AttributeError) as e:
        raise RuntimeError(f"incompatible or unreadable checkpoint at "
                           f"{path!r}: {e}") from e
    with torch.no_grad():
        for k, p in model.params().items():
            p.copy_(torch.from_numpy(tree[k]))
    if state is not None:
        state.reshard()
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
               seed: int = 0, device="cuda", group=None,
               n_spatial: int = 1, n_model: int = 1) -> dict:
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
    over, this process being one rank on ``device``, its ranks a (data,
    ``n_spatial``, ``n_model``) mesh in the order of
    `parallel.mesh.grid_coords` (`make_train_step`).  Each rank's
    ``train_batches`` yields its data index's ``cfg.batch_size / n_data``
    crops (the same on the spatial and model ranks of a data index) and
    the same number of batches; every rank starts from the same
    parameters (``start_params``, ``seed`` or ``resume_from``, read on
    each and sharded over the model axis) and passes the same
    ``validate``.  Every rank runs every collective: the step's, and at
    each checkpoint and validation the model axis's gathers of the
    parameters and of Adam's moments.  Rank 0 alone logs, validates and
    writes ``param_file``, ``metrics_file`` and the checkpoints, in the
    unsharded layout; the ranks return together, after its last write."""
    _check_config(cfg)
    device = torch.device(device)
    rank, world = world_of(group)
    n_data = grid_coords(rank, world, n_spatial, n_model)["n_data"]
    if cfg.batch_size % n_data:
        raise ValueError(f"batch size {cfg.batch_size} does not divide "
                         f"over {n_data} data-parallel processes")
    if validate is None:
        validate = bool(val_images)
    if rank != 0:
        param_file = metrics_file = val_images = None

        def log(_msg):
            pass
    tree = start_params if start_params is not None else \
        params_lib.init_params(seed, cfg.factor)
    model = SRNet(tree, cfg.factor, cfg.trunk, cfg.amp,
                  cfg.precision).to(device)
    step_fn, opt = make_train_step(cfg, model.params(), group, n_spatial,
                                   n_model)
    state = step_fn.state
    start_step = 0
    if resume_from is not None:
        start_step = _resume(resume_from, native_ckpt_dir, model, opt, log,
                             state)

    def gathered(ckpt: bool):
        """Collective over the model axis: the full parameters on every
        rank, and with ``ckpt`` Adam's state in the unsharded layout
        (None off a mesh: read it where it is written)."""
        if state is None:
            return None
        state.sync()
        return state.full_opt_state(opt) if ckpt else None

    budget_steps = cfg.max_evals // cfg.batch_size
    if max_steps is not None:
        budget_steps = min(budget_steps, max_steps)
    upload = _Uploader(device)
    mf = open(metrics_file, "a") if metrics_file else None
    t_start = time.time()
    step = last_ckpt = start_step

    def cadence(step, loss, mse):
        nonlocal last_ckpt
        do_ckpt = step % cfg.checkpoint_every == 0 or step == 1
        do_val = validate and (step % cfg.val_every == 0 or step == 1)
        if not (do_ckpt or do_val):
            return
        if do_ckpt:
            last_ckpt = step
        opt_state = gathered(do_ckpt)
        if rank != 0:
            return
        host = model.tree()
        if do_ckpt and param_file is not None:
            params_lib.save_rsr_file(param_file, host, cfg.factor)
        if do_ckpt and native_ckpt_dir is not None:
            from rusty_sr_tpu_torch.train import checkpoint as _ck
            _ck.save_native(native_ckpt_dir, step, host,
                            opt_state or opt.state_dict())
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
    # The final parameters, whatever the cadence.
    opt_state = gathered(step > last_ckpt)
    host = model.tree()
    if param_file is not None and step > last_ckpt:
        params_lib.save_rsr_file(param_file, host, cfg.factor)
    if rank == 0 and native_ckpt_dir is not None and step > last_ckpt:
        from rusty_sr_tpu_torch.train import checkpoint as _ck
        _ck.save_native(native_ckpt_dir, step, host,
                        opt_state or opt.state_dict())
    if group is not None:
        # No rank returns before rank 0's last write.
        nccl = dist.get_backend(group) == "nccl"
        dist.barrier(group=group, device_ids=[
            torch.cuda.current_device() if device.index is None
            else device.index] if nccl else None)
    return host
