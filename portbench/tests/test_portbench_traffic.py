"""The traffic generators are deterministic in the seed, and every seed
sends the same work."""

import numpy as np

from portbench import control, images


def test_pictures_deterministic_in_seed():
    big = 2 ** 31 + 12345
    a = images.pictures(big, "frames", 3, 24, 32).numpy()
    b = images.pictures(big, "frames", 3, 24, 32).numpy()
    c = images.pictures(big + 1, "frames", 3, 24, 32).numpy()
    assert a.dtype == np.uint8 and a.shape == (3, 24, 32, 3)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    # flat colours, not noise: most neighbours are equal
    assert np.mean(a[:, :, 1:] == a[:, :, :-1]) > 0.3


def test_streams_are_independent():
    a = images.pictures(5, "frames", 1, 16, 16).numpy()
    b = images.pictures(5, "train", 1, 16, 16).numpy()
    assert not np.array_equal(a, b)


def test_png_round_trip():
    img = images.pictures(9, "requests.0", 1, 20, 30).numpy()[0]
    data = images.png_encode_rgb(img, 6)
    assert np.array_equal(images.png_decode_rgb(data), img)


def test_request_order_same_mix_every_seed():
    def sizes(seed, n=4, blocks=50):
        r = images.rng(seed, "requests.order")
        return np.concatenate([r.permutation(n) for _ in range(blocks)])
    a, b = sizes(1), sizes(2 ** 31 + 7)
    assert not np.array_equal(a, b)
    assert np.array_equal(np.bincount(a), np.bincount(b))


def test_control_crops_deterministic(tiny):
    tr = dict(tiny["x3_train_amp_b32"])
    a = control.crops(3, tr)
    b = control.crops(3, tr)
    assert len(a) == 3 and a[0].shape == (4, 24, 24, 3)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
