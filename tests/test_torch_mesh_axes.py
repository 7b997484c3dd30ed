"""The mesh's spatial and model axes in the port (`parallel/mesh.py`,
`train/loop.py`'s mesh step) against the JAX package's, on the CPU.

Training: the port's ranks are gloo processes on the CPU, one per mesh
device, each fed its data index's share of the global batch; JAX's step
is `make_train_step(cfg, mesh, spatial=)` over its 8 virtual CPU
devices (`shard_train_state` on a model axis), on the same batches from
the same init.  Two steps, so that the second gathers parameters that
the first updated.  Every rank's parameters are bit-identical after the
gather (one reduction result, one Adam update, shards assembled by a sum
with zeros), and the first step's loss (the forward before any update)
is JAX's mesh step's within rel 1e-5.

- f32: the losses rel 1e-5 and the parameters atol 2e-6 of JAX's mesh
  step after each step, JAX's own bounds for its mesh step against one
  device (tests/test_multichip.py); the reduced gradient within 1e-4 of
  each leaf's largest magnitude of the port's one-process gradient on
  the global batch, the suite's f32 gradient bound
  (tests/test_torch_train_step.py; CPU sums in another order, measured
  up to 1.2e-5 where a leaf's terms cancel).
- ``--amp`` and the packed trunk: the bf16 convolutions' gradients stay
  float32 through the all-reduce (the activations' too, so a spatial
  shard's halo rows carry no rounding of their own), and the step rounds
  each convolution weight's summed gradient to bf16 once, as one process
  rounds its whole gradient once.  So the reduced gradient is held to
  the one-process gradient on the global batch within 1e-4 of each
  leaf's largest magnitude, like f32's, except for entries exactly one
  bf16 ulp apart (the two f32 sums, in other orders, on either side of a
  rounding midpoint), on at most 1e-3 of a leaf's entries (measured: 2
  of conv0's 2400 entries on (2,1,2) --amp, 1 elsewhere); every entry
  of the gradient is a bf16 value.  Adam's first step moves a weight by
  lr * g / (|g| + eps), about lr * sign(g): the parameters after step 1
  within atol 1e-4 of one process's wherever the two gradients' signs
  agree; the second step's loss within rel 1e-5 (measured up to
  7.6e-7).  The one-process gradient is taken on one thread, as the
  ranks', so that its f32 sums are the same on every run.

Serving: `make_sharded_apply` with a spatial axis against JAX's at atol
1e-5 (tests/test_multichip.py::test_mesh_shapes_inference).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rusty_sr_tpu.parallel import mesh as jmesh
from rusty_sr_tpu.train.loop import TrainConfig as JTrainConfig
from rusty_sr_tpu.train.loop import make_train_step as j_make_train_step
from rusty_sr_tpu_torch.params import init_params
from rusty_sr_tpu_torch.parallel import mesh as M
from rusty_sr_tpu_torch.train import loop as TL
from test_torch_multiprocess import free_port, run_ranks

TIERS = {"f32": dict(), "amp": dict(amp=True), "packed": dict(trunk="packed")}

# One rank of a mesh of gloo processes: two steps of `make_train_step` on
# its data index's share of each global batch; then the model axis's
# gather, and the full parameters and both losses written out.
WORKER = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from rusty_sr_tpu_torch.parallel.mesh import grid_coords
from rusty_sr_tpu_torch.train import loop as TL

port, rank, world, ns, nm = (int(a) for a in sys.argv[1:6])
inp, out, tier = sys.argv[6:9]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank)
d = np.load(inp)
names = [k[2:] for k in d.files if k.startswith("p_")]
p = {k: torch.tensor(d["p_" + k], requires_grad=True) for k in names}
kw = {"f32": {}, "amp": {"amp": True}, "packed": {"trunk": "packed"}}[tier]
hr = d["hr"]
cfg = TL.TrainConfig(crop=hr.shape[2], batch_size=hr.shape[1], **kw)
step, opt = TL.make_train_step(cfg, p, dist.group.WORLD, ns, nm)
c = grid_coords(rank, world, ns, nm)
nb = hr.shape[1] // c["n_data"]
res = {"held": sum(v.numel() for v in step.state.held.values())}
losses = []
for i, b in enumerate(hr):
    losses.append(float(step(torch.from_numpy(
        b[c["data"] * nb:(c["data"] + 1) * nb]))[0]))
    if i == 0:      # the reduced gradient: this rank's part of each leaf
        res.update({"g_" + k: h.grad.numpy().copy()
                    for k, h in step.state.held.items()})
    step.state.sync()
    res.update({f"p{i + 1}_" + k: v.detach().numpy().copy()
                for k, v in p.items()})
np.savez(out, losses=np.float32(losses), **res)
dist.destroy_process_group()
"""


def mesh_ranks(tmp_path, tree, hr, axes, tier):
    """The port's ranks on a (data, spatial, model) mesh: their outputs."""
    nd, ns, nm = axes
    world = nd * ns * nm
    inp = str(tmp_path / "in.npz")
    np.savez(inp, hr=hr, **{"p_" + k: v for k, v in tree.items()})
    port = free_port()
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(world)]
    for rc, text in run_ranks([[sys.executable, "-c", WORKER, str(port),
                                str(r), str(world), str(ns), str(nm), inp,
                                outs[r], tier] for r in range(world)]):
        assert rc == 0, text
    return [np.load(o) for o in outs]


def jax_steps(tree, hr, axes, tier):
    """JAX's steps over the batches ``hr``, on a mesh of ``axes`` or, for
    None, on one device: (losses, parameters)."""
    cfg = JTrainConfig(factor=3, batch_size=hr.shape[1], crop=hr.shape[2],
                       **TIERS[tier])
    mesh = None if axes is None else jmesh.make_mesh(*axes)
    step, opt = j_make_train_step(cfg, mesh, spatial=mesh is not None
                                  and axes[1] > 1)
    p = {k: jnp.asarray(v) for k, v in tree.items()}
    s = opt.init(p)
    if mesh is not None and axes[2] > 1:
        p, s = jmesh.shard_train_state(mesh, p, s)
    losses = []
    for b in hr:
        p, s, loss, _ = step(p, s, jnp.asarray(b))
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in p.items()}


def port_steps(tree, hr, tier):
    """The port's one-process steps over the batches ``hr``, on one
    thread: (losses, the first step's gradient, the parameters after
    it)."""
    cfg = TL.TrainConfig(crop=hr.shape[2], batch_size=hr.shape[1],
                         **TIERS[tier])
    p = {k: torch.tensor(v, requires_grad=True) for k, v in tree.items()}
    step, _ = TL.make_train_step(cfg, p)
    losses, grad, p1 = [], None, None
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for b in hr:
            losses.append(float(step(torch.from_numpy(b))[0]))
            if grad is None:
                grad = {k: v.grad.numpy().copy() for k, v in p.items()}
                p1 = {k: v.detach().numpy().copy() for k, v in p.items()}
    finally:
        torch.set_num_threads(threads)
    return losses, grad, p1


def assert_bf16_sum_close(got, want, scale, name):
    """``got`` within 1e-4 * ``scale`` of ``want``, both bf16 values,
    except for entries one bf16 ulp apart on at most 1e-3 of them."""
    g, w = torch.from_numpy(got), torch.from_numpy(want)
    for t in (g, w):
        assert torch.equal(t, t.to(torch.bfloat16).float()), name
    off = (g - w).abs() > 1e-4 * scale
    assert float(off.float().mean()) <= 1e-3, (name, int(off.sum()))
    bits = [t[off].to(torch.bfloat16).view(torch.int16).int()
            for t in (g, w)]
    assert bool(((bits[0] - bits[1]).abs() == 1).all()), name


CASES = [((2, 2, 1), t) for t in TIERS] + [((2, 1, 2), t) for t in TIERS] \
    + [((1, 2, 2), "f32"), ((1, 4, 1), "packed")]


@pytest.mark.parametrize("axes,tier", CASES,
                         ids=[f"{a[0]}x{a[1]}x{a[2]}-{t}" for a, t in CASES])
def test_mesh_step_matches_jax(tmp_path, axes, tier):
    """Two steps on a global batch of 4 crops of 72 (LR 24 rows: a
    spatial shard computes its rows and 8 more each side, less than the
    crop, so the halo is what makes it exact)."""
    tree = init_params(5, 3)
    hr = np.random.default_rng(17).random((2, 4, 72, 72, 3),
                                          dtype=np.float32)
    ranks = mesh_ranks(tmp_path, tree, hr, axes, tier)
    for r in ranks[1:]:
        for k in tree:
            for p in ("p1_", "p2_"):
                assert r[p + k].tobytes() == ranks[0][p + k].tobytes(), k
        assert r["losses"].tobytes() == ranks[0]["losses"].tobytes()
    full = sum(v.size for v in tree.values())
    if axes[2] > 1:     # the model ranks hold shards, not the whole tree
        assert int(ranks[0]["held"]) < full
    else:
        assert int(ranks[0]["held"]) == full
    got_l = ranks[0]["losses"]
    j_l, j_p = jax_steps(tree, hr, axes, tier)
    np.testing.assert_allclose(got_l[0], j_l[0], rtol=1e-5)
    # The reduced gradient of step 1, the model peers' shards put together.
    grad = {k: np.concatenate([ranks[m]["g_" + k] for m in range(axes[2])],
                              axis=-1)
            if ranks[0]["g_" + k].shape != tree[k].shape
            else ranks[0]["g_" + k] for k in tree}
    one_l, one_g, one_p1 = port_steps(tree, hr, tier)
    for k in tree:
        scale = float(np.abs(one_g[k]).max())
        if tier == "f32" or not k.startswith("conv"):
            np.testing.assert_allclose(grad[k], one_g[k], rtol=0,
                                       atol=1e-4 * scale, err_msg=k)
        else:
            assert_bf16_sum_close(grad[k], one_g[k], scale, k)
    if tier != "f32":
        np.testing.assert_allclose(got_l, one_l, rtol=1e-5)
        for k in tree:
            agree = np.sign(grad[k]) == np.sign(one_g[k])
            np.testing.assert_allclose(ranks[0]["p1_" + k][agree],
                                       one_p1[k][agree], rtol=0, atol=1e-4,
                                       err_msg=k)
        return
    np.testing.assert_allclose(got_l, j_l, rtol=1e-5)
    for k in tree:
        np.testing.assert_allclose(ranks[0]["p2_" + k], j_p[k], rtol=0,
                                   atol=2e-6, err_msg=k)
    _, j_p1 = jax_steps(tree, hr[:1], axes, tier)
    for k in tree:
        np.testing.assert_allclose(ranks[0]["p1_" + k], j_p1[k], rtol=0,
                                   atol=2e-6, err_msg=k)


@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (2, 4, 1), (1, 2, 2)])
def test_sharded_apply_with_spatial_axis_matches_jax(shape):
    nd, ns, nm = (*shape, 1)[:3]
    tree = init_params(0, 3)
    x = np.random.default_rng(3).random((nd, 8 * ns + 3, 16, 3),
                                        dtype=np.float32)
    mesh = M.make_mesh(nd, ns, nm, devices=["cpu"] * (nd * ns * nm))
    apply = M.make_sharded_apply(mesh, 3)

    def sharded(xx):
        shards = M.shard_batch(mesh, xx)
        assert len(shards) == nd * ns * nm
        return M.unshard_batch(mesh, apply(tree, shards)).numpy()

    # JAX's spatial sharding needs H to divide; the port's splits any H,
    # which the whole-image net checks.
    jm = jmesh.make_mesh(n_data=nd, n_spatial=ns, n_model=nm)
    want = np.asarray(jmesh.make_sharded_apply(jm, 3)(
        {k: jnp.asarray(v) for k, v in tree.items()},
        jmesh.shard_batch(jm, x[:, :8 * ns])))
    np.testing.assert_allclose(sharded(x[:, :8 * ns]), want, atol=1e-5)
    whole = M.make_sharded_apply(M.make_mesh(1, devices=["cpu"]), 3)(
        tree, [torch.from_numpy(x)])[0]
    np.testing.assert_allclose(sharded(x), whole.numpy(), atol=1e-5)


@pytest.mark.parametrize("n_model", [2, 4])
def test_tp_spec_and_shard_train_state_match_jax(n_model):
    """The rule over every leaf of the param tree and of Adam's state,
    against `_tp_spec` over the same tree and over optax's state."""
    import optax
    tree = init_params(0, 3)
    jstate = optax.adam(2e-3).init({k: jnp.asarray(v)
                                    for k, v in tree.items()})
    for leaf in jax.tree.leaves(jstate) + list(tree.values()):
        assert M.tp_spec(leaf, n_model) == \
            tuple(jmesh._tp_spec(leaf, n_model)), np.shape(leaf)
    sharded = {k for k, v in tree.items() if M.tp_spec(v, n_model)}
    assert "expand_bias" not in sharded and "conv10" not in sharded
    assert {"conv0", "conv1", "f_bias", "l3_belu"} <= sharded
    p = {k: torch.tensor(v) for k, v in tree.items()}
    opt = TL.make_optimizer(TL.TrainConfig(), p)
    for v in p.values():
        v.grad = torch.ones_like(v)
    opt.step()
    state = {k: opt.state[v] for k, v in p.items()}
    parts = [M.shard_train_state(p, state, n_model, m)
             for m in range(n_model)]
    for k, v in p.items():
        axis = -1 if k in sharded else None
        for name in ("exp_avg", "exp_avg_sq"):
            got = [pt[1][k][name] for pt in parts]
            if axis is None:
                assert all(g is state[k][name] for g in got)
            else:
                assert torch.equal(torch.cat(got, dim=-1), state[k][name])
        assert all(pt[1][k]["step"] is state[k]["step"] for pt in parts)
        got = [pt[0][k] for pt in parts]
        if axis is None:
            assert all(g is v for g in got)
        else:
            assert all(g.shape[-1] == v.shape[-1] // n_model for g in got)
            assert torch.equal(torch.cat(got, dim=-1), v)


def test_rows_split_evenly_with_a_halo():
    assert M.rows(10, 3, 0) == (0, 4, 0, 10)
    assert [M.rows(40, 3, s)[:2] for s in range(3)] == [(0, 14), (14, 27),
                                                        (27, 40)]
    assert M.rows(40, 3, 1) == (14, 27, 6, 35)
    assert [M.rows(24, 4, s, unit=2)[:2] for s in range(4)] == [
        (0, 6), (6, 12), (12, 18), (18, 24)]
    with pytest.raises(ValueError, match="spatial shards"):
        M.rows(3, 4, 0)
    with pytest.raises(ValueError, match="2-row"):
        M.rows(6, 4, 0, unit=2)


def test_grid_coords_follow_the_mesh_reshape():
    """rank = (d * S + s) * M + m, the order of JAX's
    ``np.asarray(devices).reshape(n_data, n_spatial, n_model)``."""
    ranks = np.arange(12).reshape(3, 2, 2)
    for d in range(3):
        for s in range(2):
            for m in range(2):
                c = M.grid_coords(int(ranks[d, s, m]), 12, 2, 2)
                assert (c["data"], c["spatial"], c["model"],
                        c["n_data"]) == (d, s, m, 3)
    with pytest.raises(ValueError, match="do not make a mesh"):
        M.grid_coords(0, 6, 4, 1)
    mesh = M.make_mesh(3, 2, 2, devices=[f"cuda:{i}" for i in range(12)])
    assert mesh.device(2, 1, 0) == torch.device("cuda", int(ranks[2, 1, 0]))
    assert mesh.lanes == tuple(torch.device("cuda", i) for i in (0, 4, 8))
