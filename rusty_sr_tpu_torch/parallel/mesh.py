"""Device meshes: the `data` axis of `rusty_sr_tpu/parallel/mesh.py`.

The JAX package shards over a (data, spatial, model) `jax.sharding.Mesh`
and lets XLA insert the collectives.  The port runs the data axis by
hand:

- serving: each chunk of tiles is split evenly over the mesh's devices,
  each device holding its own copy of the weights
  (`parallel.tiling.tiled_sr_batch(mesh=)`, and `tiled_sr_sharded`);
  the forward pass needs no collective;
- the whole-image net over a batch split across the devices
  (`make_sharded_apply`, `shard_batch`);
- training runs one process per device over `torch.distributed`
  (`train.loop.train_loop(group=)`), not through a mesh object.

A mesh is an ordered list of `torch.device`s.  On the CPU (the tests,
``--platform cpu``) a mesh of N is N entries of the CPU device, standing
in for N cards as the JAX suite's virtual CPU devices do; an explicit
list may repeat a card, which runs N replicas on it.  The ``spatial``
and ``model`` axes (GSPMD's halo exchange and channel sharding) are not
ported: asking for either raises.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

_AXES_NOT_PORTED = ("the 'spatial' and 'model' mesh axes are not ported "
                    "yet to the PyTorch package")


class Mesh:
    """The devices of a data-parallel mesh, in data-axis order; ``shape``
    has the keys of a JAX mesh's."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(torch.device(d) for d in devices)
        self.shape = {"data": len(self.devices), "spatial": 1, "model": 1}


def make_mesh(n_data: Optional[int] = None, n_spatial: int = 1,
              n_model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``n_data`` devices (default: all of ``devices``) taken
    from ``devices`` (default: the visible CUDA devices).  Raises
    ValueError for more devices than there are, and for a ``spatial`` or
    ``model`` axis other than 1."""
    if n_spatial != 1 or n_model != 1:
        raise ValueError(f"{_AXES_NOT_PORTED} (asked for spatial="
                         f"{n_spatial}, model={n_model})")
    if devices is None:
        if not torch.cuda.is_available():
            raise ValueError("no CUDA device for the mesh; give devices= "
                             "(a mesh of N on the CPU is N entries of "
                             "'cpu')")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_data is None:
        n_data = len(devices)
    if not 1 <= n_data <= len(devices):
        raise ValueError(f"need {n_data}x{n_spatial}x{n_model} devices, "
                         f"have {len(devices)}")
    return Mesh(devices[:n_data])


def shard_batch(mesh: Mesh, batch) -> list:
    """A host batch (N, ...) -> one tensor per mesh device, split evenly
    along N (the JAX package's 'data' sharding; N must divide)."""
    n = mesh.shape["data"]
    batch = torch.as_tensor(np.asarray(batch))
    if batch.shape[0] % n:
        raise ValueError(f"a batch of {batch.shape[0]} does not split "
                         f"evenly over {n} devices")
    return [s.to(d) for s, d in zip(torch.chunk(batch, n), mesh.devices)]


def make_sharded_apply(mesh: Mesh, factor: int = 3, compute_dtype=None):
    """``apply(params, shards) -> shards``: the whole-image net
    (`models.sr_net.sr_apply`) on each device's part of a batch from
    `shard_batch`, with the parameters (a tree of numpy arrays or
    tensors) copied to every device, as the JAX package replicates
    them."""
    from rusty_sr_tpu_torch.models.sr_net import sr_apply
    from rusty_sr_tpu_torch.params import to_torch

    def apply(params, shards):
        if len(shards) != len(mesh.devices):
            raise ValueError(f"{len(shards)} shards for a mesh of "
                             f"{len(mesh.devices)} devices")
        host = {k: np.asarray(torch.as_tensor(v).detach().cpu(), np.float32)
                for k, v in params.items()}
        with torch.no_grad():
            return [sr_apply(to_torch(host, d), x.to(d), factor,
                             compute_dtype=compute_dtype)
                    for x, d in zip(shards, mesh.devices)]

    return apply


def tiled_sr_sharded(params, image: np.ndarray, mesh: Mesh, factor: int = 3,
                     *, tile: int = 242, chunk: Optional[int] = None,
                     compute_dtype=None) -> np.ndarray:
    """Overlap-tile inference with each chunk of tiles split over the
    mesh's devices: `parallel.tiling.tiled_sr_batch(mesh=)` on a
    one-image batch, so the output is byte-identical to the
    single-device path.  ``chunk`` counts tiles per device."""
    from rusty_sr_tpu_torch.parallel.tiling import tiled_sr_batch
    return tiled_sr_batch(params, [np.asarray(image)], factor, tile=tile,
                          chunk=chunk, compute_dtype=compute_dtype,
                          mesh=mesh)[0]
