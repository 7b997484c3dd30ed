"""The plain reference against the port's plain CPU path at a tiny size,
for each configuration, and the sound cells judged correct on the CPU."""

import os

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference import check, net


def config(name):
    return harness.load_json(os.path.join(harness.BENCH, "configs",
                                          name + ".json"))


@pytest.mark.parametrize("name", ["rusty_sr_x3", "rusty_sr_x4"])
def test_forward_matches_port_plain_path(name):
    from rusty_sr_tpu_torch.models.sr_net import sr_apply
    from rusty_sr_tpu_torch.params import load_rsr_file

    cfg = config(name)
    path = os.path.join(harness.ROOT, cfg["weights"])
    ref = {k: torch.as_tensor(v) for k, v in net.read_rsr(path, cfg).items()}
    prog = {k: torch.as_tensor(v) for k, v in
            load_rsr_file(path, cfg["factor"]).items()}
    x = torch.rand(2, 13, 17, 3, generator=torch.Generator().manual_seed(1))
    want = sr_apply(prog, x, cfg["factor"])
    got = net.forward(ref, x.permute(0, 3, 1, 2), cfg["factor"])
    # float32 sums in other orders: well under 1e-5 on outputs near 1
    torch.testing.assert_close(got.permute(0, 2, 3, 1), want, atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("name", ["rusty_sr_x3", "rusty_sr_x4"])
def test_init_matches_port(name):
    from rusty_sr_tpu_torch.params import init_params
    cfg = config(name)
    seed = 2 ** 31 + 99
    want = init_params(seed, cfg["factor"])
    got = net.hwio(net.init_params(seed, cfg))
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("name", ["rusty_sr_x3", "rusty_sr_x4"])
def test_train_steps_match_port_f32_step(name):
    from rusty_sr_tpu_torch.models.sr_net import SRNet
    from rusty_sr_tpu_torch.train.loop import TrainConfig, make_train_step

    cfg = config(name)
    f = cfg["factor"]
    recipe = harness.load_json(os.path.join(
        harness.BENCH, "traffic", "train_amp_crop192_b32.json"))["recipe"]
    tree0 = net.init_params(5, cfg)
    r = np.random.default_rng(0)
    batches = [r.integers(0, 256, (2, 4 * f, 4 * f, 3), dtype=np.uint8)
               for _ in range(3)]
    tcfg = TrainConfig(factor=f, batch_size=2, crop=4 * f)
    model = SRNet(net.hwio(tree0), f)
    step, opt = make_train_step(tcfg, model.params())
    losses, grad1 = [], None
    for b in batches:
        loss, _ = step(torch.as_tensor(b))
        losses.append(float(loss))
        if grad1 is None:
            grad1 = {k: p.grad.double().numpy()
                     for k, p in model.params().items()}
    delta = {k: v.astype(np.float64) - net.hwio(tree0)[k]
             for k, v in model.tree().items()}
    ref = net.train_steps(tree0, batches, cfg, recipe, "cpu")
    gaps = check.train_gaps({"losses": losses, "grad1": net.oihw(grad1),
                             "delta": net.oihw(delta)}, ref)
    # the same float32 arithmetic in other orders
    assert gaps["loss_gap"] < 1e-5
    assert gaps["grad_gap"] < 1e-4
    assert gaps["grad_diff"] < 1e-4
    assert gaps["delta_gap"] < 1e-3


@pytest.mark.parametrize("cell", ["x3_frames_fast", "x4_frames_fast",
                                  "x3_requests_exact", "x3_train_amp_b32"])
def test_sound_cell_is_correct_on_cpu(cell, tiny, bench):
    r = harness.run_cell(cell, 2 ** 31 + 3, 3.0, False, device="cpu",
                         traffic_overrides=tiny[cell], bench=bench)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


def test_image_gaps_and_judge():
    a = np.zeros((2, 2, 3), np.uint8)
    b = a.copy()
    b[0, 0, 0] = 3
    g = check.image_gaps(a, b)
    assert g == {"max_code_gap": 3, "mean_code_gap": 3 / 12}
    ok, rows = check.judge(g, {"max_code_gap": 3, "mean_code_gap": 0.1})
    assert not ok and rows["max_code_gap"]["limit"] == 3
    # only the numbers a limit names are compared; a limit needs its number
    assert check.judge(g, {"max_code_gap": 3})[0]
    assert not check.judge(g, {"grad_diff": 1.0})[0]
    assert not check.judge(check.merge_image_gaps([]),
                           {"max_code_gap": 3})[0]
