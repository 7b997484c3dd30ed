"""Device meshes: the (data, spatial, model) axes of
`rusty_sr_tpu/parallel/mesh.py`.

The JAX package shards over a (data, spatial, model) `jax.sharding.Mesh`
and lets XLA insert the collectives.  The port runs the axes by hand:

- ``data``: serving splits each chunk of tiles evenly over the data
  axis's devices, each holding its own copy of the weights
  (`parallel.tiling.tiled_sr_batch(mesh=)`, and `tiled_sr_sharded`); a
  mesh with ``spatial`` or ``model`` above 1 runs the tiles on one device
  per data index (JAX replicates each chunk over the other axes, which
  computes the same bytes).  Training splits the batch over the data
  index of each process (`RankGrid`).
- ``spatial``: the image's rows are split as evenly as possible (`rows`);
  each device computes its rows plus `HALO_T` halo rows on each side,
  taken from its neighbours' rows once, before the first convolution,
  and keeps its own rows of the result.  The net's receptive field is 7
  LR rows (`parallel.tiling.HALO`), so those rows are exact: the whole
  image's values, summed in the same order.  GSPMD instead exchanges a
  halo around each convolution.  At an image's top and bottom edge the
  shard's edge is the image's, so Same padding and the edge-clamped
  bilinear base apply unchanged.
- ``model``: each process keeps the `tp_spec` shard of every parameter
  and of its Adam moments (`shard_train_state`); the full parameters are
  gathered over the axis before each step, and the step's compute is
  replicated over it (XLA splits the convolutions' channels instead).

A mesh is an array of `torch.device`s shaped (data, spatial, model).  On
the CPU (the tests, ``--platform cpu``) a mesh of N is N entries of the
CPU device, standing in for N cards as the JAX suite's virtual CPU
devices do; an explicit list may repeat a card, which runs N replicas on
it.  Training runs one process per device over `torch.distributed`
(`train.loop.train_loop(group=, n_spatial=, n_model=)`), each process
placed on the mesh by `RankGrid`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

# Halo rows (LR) a spatial shard computes beyond its own on each side: the
# net's receptive field (parallel.tiling.HALO = 7) rounded up to 8, so that
# the packed trunk's 2x2 pairs and the fxf pool keep their global
# alignment.
HALO_T = 8

AXES = ("data", "spatial", "model")


class Mesh:
    """The devices of a (data, spatial, model) mesh.  ``devices``: all of
    them in row-major (d, s, m) order, as JAX reshapes its device list;
    ``shape`` maps the axis names to their sizes; ``lanes``: one device
    per data index (the (d, 0, 0) devices), which serving runs tiles
    on."""

    def __init__(self, devices: Sequence, n_spatial: int = 1,
                 n_model: int = 1):
        self.devices = tuple(torch.device(d) for d in devices)
        per = n_spatial * n_model
        if not self.devices or len(self.devices) % per:
            raise ValueError(f"{len(self.devices)} devices do not make a "
                             f"mesh of spatial={n_spatial}, model={n_model}")
        self.shape = {"data": len(self.devices) // per,
                      "spatial": n_spatial, "model": n_model}
        self.lanes = self.devices[::per]

    def device(self, d: int, s: int = 0, m: int = 0) -> torch.device:
        return self.devices[(d * self.shape["spatial"] + s)
                            * self.shape["model"] + m]


def make_mesh(n_data: Optional[int] = None, n_spatial: int = 1,
              n_model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (data, spatial, model) mesh over the first n_data * n_spatial *
    n_model of ``devices`` (default: the visible CUDA devices); ``n_data``
    defaults to as many as they hold.  Raises ValueError for more devices
    than there are."""
    if devices is None:
        if not torch.cuda.is_available():
            raise ValueError("no CUDA device for the mesh; give devices= "
                             "(a mesh of N on the CPU is N entries of "
                             "'cpu')")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if min(n_spatial, n_model) < 1:
        raise ValueError("every mesh axis must be >= 1")
    if n_data is None:
        n_data = len(devices) // (n_spatial * n_model)
    need = n_data * n_spatial * n_model
    if n_data < 1 or need > len(devices):
        raise ValueError(f"need {n_data}x{n_spatial}x{n_model} devices, "
                         f"have {len(devices)}")
    return Mesh(devices[:need], n_spatial, n_model)


def rows(n: int, parts: int, part: int, unit: int = 1,
         halo: int = HALO_T) -> tuple:
    """Part ``part`` of ``parts`` of ``n`` rows, split as evenly as
    possible in whole ``unit``s (the packed trunk splits row pairs):
    (lo, hi) its own rows and (wlo, whi) those it computes, ``halo`` more
    on each side where the image has them.  ValueError when there are
    more parts than units of rows."""
    units = n // unit
    if n % unit or parts > units:
        raise ValueError(f"{n} rows do not split into {parts} spatial "
                         f"shards" + (f" of whole {unit}-row units"
                                      if unit > 1 else ""))
    base, extra = divmod(units, parts)
    lo = (part * base + min(part, extra)) * unit
    hi = lo + (base + (part < extra)) * unit
    return lo, hi, max(0, lo - halo), min(n, hi + halo)


def tp_spec(x, n_model: int) -> tuple:
    """The model-axis rule of `rusty_sr_tpu/parallel/mesh.py::_tp_spec`,
    as the entries of its PartitionSpec: a 4-D kernel whose output
    channels divide by ``n_model`` shards them, ``(None, None, None,
    'model')``; a vector that divides and holds at least ``n_model``
    values shards, ``('model',)`` (the 27-channel expand segments stay
    replicated); anything else (Adam's step counts) replicates, ``()``."""
    shape = tuple(np.shape(x))
    if len(shape) == 4 and shape[-1] % n_model == 0:
        return (None, None, None, "model")
    if len(shape) == 1 and shape[0] % n_model == 0 and shape[0] >= n_model:
        return ("model",)
    return ()


def shard_of(x, n_model: int, m: int):
    """Model rank ``m``'s part of ``x`` under `tp_spec` (a slice of its last
    axis; the whole of a replicated leaf)."""
    if not tp_spec(x, n_model):
        return x
    c = np.shape(x)[-1] // n_model
    return x[..., m * c:(m + 1) * c]


def shard_train_state(params: dict, opt_state: dict, n_model: int,
                      m: int) -> tuple:
    """Model rank ``m``'s part of a train state: ``params`` (name ->
    tensor or array) and ``opt_state`` (name -> Adam's per-parameter
    state, e.g. {'step', 'exp_avg', 'exp_avg_sq'}), every leaf sharded by
    `tp_spec`, as the JAX package maps its rule over the param tree and
    the optax state alike."""
    return ({k: shard_of(v, n_model, m) for k, v in params.items()},
            {k: {n: shard_of(v, n_model, m) for n, v in st.items()}
             for k, st in opt_state.items()})


def shard_batch(mesh: Mesh, batch) -> list:
    """A host batch (N, H, ...) -> one tensor per mesh device, in
    ``mesh.devices`` order: N split evenly over 'data' (N must divide), H
    as evenly as possible over 'spatial' (`rows`, no halo), replicated
    over 'model'."""
    nd, ns, nm = (mesh.shape[a] for a in AXES)
    batch = torch.as_tensor(np.asarray(batch))
    if batch.shape[0] % nd:
        raise ValueError(f"a batch of {batch.shape[0]} does not split "
                         f"evenly over {nd} devices")
    out = []
    for d, part in enumerate(torch.chunk(batch, nd)):
        for s in range(ns):
            lo, hi, _, _ = rows(part.shape[1], ns, s)
            out += [part[:, lo:hi].to(mesh.device(d, s, m))
                    for m in range(nm)]
    return out


def unshard_batch(mesh: Mesh, shards) -> torch.Tensor:
    """The inverse of `shard_batch`: the (d, s, 0) shards put back
    together on the CPU."""
    ns, nm = mesh.shape["spatial"], mesh.shape["model"]
    cells = [s.detach().cpu() for s in list(shards)[::nm]]
    return torch.cat([torch.cat(cells[i:i + ns], dim=1)
                      for i in range(0, len(cells), ns)])


def make_sharded_apply(mesh: Mesh, factor: int = 3, compute_dtype=None):
    """``apply(params, shards) -> shards``: the whole-image net
    (`models.sr_net.sr_apply`) over a batch laid out by `shard_batch`,
    with the parameters (a tree of numpy arrays or tensors) copied to
    every device, as the JAX package replicates them.  Each device takes
    `HALO_T` rows on each side of its own from the shards of its data
    index (a halo exchange, once), runs the net and keeps its own rows
    of the output; `unshard_batch` assembles the result."""
    from rusty_sr_tpu_torch.models.sr_net import sr_apply
    from rusty_sr_tpu_torch.params import to_torch

    nd, ns, nm = (mesh.shape[a] for a in AXES)

    def apply(params, shards):
        shards = list(shards)
        if len(shards) != len(mesh.devices):
            raise ValueError(f"{len(shards)} shards for a mesh of "
                             f"{len(mesh.devices)} devices")
        host = {k: np.asarray(torch.as_tensor(v).detach().cpu(), np.float32)
                for k, v in params.items()}
        out = []
        with torch.no_grad():
            for d in range(nd):
                own = [shards[(d * ns + s) * nm] for s in range(ns)]
                h = sum(t.shape[1] for t in own)
                for s in range(ns):
                    lo, hi, wlo, whi = rows(h, ns, s)
                    for m in range(nm):
                        dev = mesh.device(d, s, m)
                        x = torch.cat([t.to(dev) for t in own], dim=1) \
                            if ns > 1 else own[0].to(dev)
                        y = sr_apply(to_torch(host, dev), x[:, wlo:whi],
                                     factor, compute_dtype=compute_dtype)
                        out.append(y[:, factor * (lo - wlo):
                                     factor * (hi - wlo)])
        return out

    return apply


def tiled_sr_sharded(params, image: np.ndarray, mesh: Mesh, factor: int = 3,
                     *, tile: int = 242, chunk: Optional[int] = None,
                     compute_dtype=None, out16=None) -> np.ndarray:
    """Overlap-tile inference with each chunk of tiles split over the
    mesh's data axis: `parallel.tiling.tiled_sr_batch(mesh=)` on a
    one-image batch (``out16`` as there), so the output is
    byte-identical to the single-device path.  ``chunk`` counts tiles per
    device."""
    from rusty_sr_tpu_torch.parallel.tiling import tiled_sr_batch
    return tiled_sr_batch(params, [np.asarray(image)], factor, tile=tile,
                          chunk=chunk, compute_dtype=compute_dtype,
                          out16=out16, mesh=mesh)[0]


def grid_coords(rank: int, world: int, n_spatial: int = 1,
                n_model: int = 1) -> dict:
    """A process's place on a mesh of ``world`` processes, one device
    each, in the order of the mesh's reshape: rank = (d * S + s) * M + m.
    {'data', 'spatial', 'model'} -> its index, and 'n_data' the data
    axis's size.  ValueError unless S * M divides ``world``."""
    per = n_spatial * n_model
    if min(n_spatial, n_model) < 1 or world % per:
        raise ValueError(f"{world} processes do not make a mesh of "
                         f"spatial={n_spatial}, model={n_model}")
    return {"data": rank // per, "spatial": (rank // n_model) % n_spatial,
            "model": rank % n_model, "n_data": world // per}


class RankGrid:
    """This process's place on a (data, spatial, model) mesh of processes,
    one device each (`grid_coords`), and the two subgroups that a
    training step talks over:

    - ``reduce_group``: the ranks that share this one's model index (the
      data and spatial axes), which sum the gradients, the loss and the
      mse; None where it would hold this rank alone;
    - ``model_group``: the ranks that share its (data, spatial) cell,
      which gather the model-sharded parameters and Adam moments; None
      for a model axis of 1.

    ``dist.new_group`` is collective over the whole group: every process
    builds its `RankGrid` at the same point, with the same axes."""

    def __init__(self, group, n_spatial: int = 1, n_model: int = 1):
        import torch.distributed as dist

        ranks = dist.get_process_group_ranks(group)
        world = len(ranks)
        c = grid_coords(dist.get_rank(group), world, n_spatial, n_model)
        self.coords = {a: c[a] for a in AXES}
        self.shape = {"data": c["n_data"], "spatial": n_spatial,
                      "model": n_model}
        self.rank, self.world = dist.get_rank(group), world
        if n_spatial == n_model == 1:
            self.reduce_group = group if world > 1 else None
            self.model_group = None
            return
        self.reduce_group = self.model_group = None
        for m in range(n_model):
            g = dist.new_group([r for i, r in enumerate(ranks)
                                if i % n_model == m]) \
                if world > n_model else None
            if m == self.coords["model"]:
                self.reduce_group = g
        if n_model > 1:
            for cell in range(world // n_model):
                g = dist.new_group(ranks[cell * n_model:
                                         (cell + 1) * n_model])
                if cell == self.rank // n_model:
                    self.model_group = g
