"""The reference-shaped feed of the port, `ImageFolderSupplier` and
`PrefetchBuffer` (`rusty_sr_tpu_torch/train/data.py`), against the JAX
package's (tests/test_train.py's TestData and
test_supplier_pixels_roundtrip_and_crops_are_windows, ported): the same
folders and seeds give the same images and crops byte for byte, and the
error, starvation and close cases behave alike.
"""

import time

import numpy as np
import pytest

from rusty_sr_tpu.train import data as jdata
from rusty_sr_tpu_torch.train import ImageFolderSupplier, PrefetchBuffer
from rusty_sr_tpu_torch.train.data import shard_files_for_host
from rusty_sr_tpu_torch.utils.imageio import save_image_u8

RNG = np.random.default_rng(0)


def save(path, shape, seed=None):
    r = RNG if seed is None else np.random.default_rng(seed)
    save_image_u8(str(path), r.integers(0, 256, shape, dtype=np.uint8))


def folder(tmp_path, shapes, name="ti"):
    d = tmp_path / name
    d.mkdir()
    for i, shape in enumerate(shapes):
        save(d / f"img{i}.png", shape, seed=i)
    return str(d)


@pytest.mark.parametrize("crop,shuffle,seed", [
    ((24, 24), True, 0), ((16, 40), True, 7), (None, False, 0),
    ((64, 64), True, 3)],
    ids=["crop", "wide-crop", "sequential", "padded"])
def test_supplier_same_images_as_jax(tmp_path, crop, shuffle, seed):
    """Two epochs (one for a sequential supplier) of the port's and JAX's
    suppliers on one folder: the same arrays, byte for byte (a crop
    larger than an image is edge-padded)."""
    src = folder(tmp_path, [(40, 50, 3), (33, 70, 3), (48, 48, 3)])
    n = 6 if shuffle else 3
    ours = ImageFolderSupplier(src, crop=crop, shuffle=shuffle, seed=seed)
    theirs = jdata.ImageFolderSupplier(src, crop=crop, shuffle=shuffle,
                                       seed=seed)
    got = [x for _, x in zip(range(n), ours)]
    want = [x for _, x in zip(range(n), theirs)]
    assert len(got) == len(want) == n
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_buffer_batches_same_as_jax(tmp_path):
    src = folder(tmp_path, [(40, 50, 3), (30, 30, 3), (45, 60, 3)])
    bufs = [PrefetchBuffer(ImageFolderSupplier(src, crop=(24, 24), seed=5),
                           depth=8, batch_size=2),
            jdata.PrefetchBuffer(jdata.ImageFolderSupplier(
                src, crop=(24, 24), seed=5), depth=8, batch_size=2)]
    try:
        for _ in range(4):
            a, b = (buf.next_batch() for buf in bufs)
            assert a.shape == (2, 24, 24, 3) and a.tobytes() == b.tobytes()
    finally:
        for buf in bufs:
            buf.close()


def test_supplier_and_buffer(tmp_path):
    for i in range(3):
        save(tmp_path / f"img{i}.png", (40, 50, 3))
    sup = ImageFolderSupplier(str(tmp_path), crop=(24, 24), shuffle=True)
    assert sup.epoch_size() == 3
    buf = PrefetchBuffer(sup, depth=8, batch_size=2)
    b = buf.next_batch()
    assert b.shape == (2, 24, 24, 3)
    assert b.dtype == np.float32
    buf.close()


def test_sequential_supplier_terminates(tmp_path):
    save(tmp_path / "a.png", (8, 8, 3))
    imgs = list(ImageFolderSupplier(str(tmp_path), crop=None,
                                    shuffle=False))
    assert len(imgs) == 1 and imgs[0].shape == (8, 8, 3)


def test_small_image_padded_crop(tmp_path):
    save(tmp_path / "small.png", (10, 10, 3))
    img = next(iter(ImageFolderSupplier(str(tmp_path), crop=(24, 24))))
    assert img.shape == (24, 24, 3)


def test_all_unreadable_raises_not_spins(tmp_path):
    """A folder of undecodable files raises (on the consumer's side for
    a PrefetchBuffer) instead of spinning."""
    for i in range(2):
        (tmp_path / f"bad{i}.png").write_bytes(b"not a png at all")
    sup = ImageFolderSupplier(str(tmp_path), crop=(8, 8), shuffle=True)
    with pytest.raises(RuntimeError, match="could be decoded"):
        next(iter(sup))
    buf = PrefetchBuffer(ImageFolderSupplier(str(tmp_path), crop=(8, 8)),
                         depth=4, batch_size=1)
    try:
        with pytest.raises(RuntimeError, match="could be decoded"):
            buf.next_batch()
    finally:
        buf.close()


def test_buffer_propagates_any_worker_crash(tmp_path):
    """A worker crash that is not a RuntimeError (np.stack over images of
    two shapes, with crop=None) is raised on the consumer, not read as a
    clean end of the stream."""
    save(tmp_path / "a.png", (8, 8, 3))
    save(tmp_path / "b.png", (12, 12, 3))
    sup = ImageFolderSupplier(str(tmp_path), crop=None, shuffle=False)
    buf = PrefetchBuffer(sup, depth=4, batch_size=2)
    try:
        with pytest.raises(ValueError):
            buf.next_batch()
    finally:
        buf.close()


def test_buffer_reraises_a_base_exception(tmp_path):
    """A BaseException in the supplier (here SystemExit) reaches the
    consumer too."""
    save(tmp_path / "a.png", (8, 8, 3))

    class Exits(ImageFolderSupplier):
        def __iter__(self):
            yield from ()
            raise SystemExit(3)

    buf = PrefetchBuffer(Exits(str(tmp_path), crop=(8, 8)), depth=2)
    try:
        with pytest.raises(SystemExit):
            buf.next_batch()
    finally:
        buf.close()


def test_buffer_rejects_zero_batch(tmp_path):
    save(tmp_path / "a.png", (8, 8, 3))
    sup = ImageFolderSupplier(str(tmp_path), crop=(8, 8))
    with pytest.raises(ValueError, match="batch_size"):
        PrefetchBuffer(sup, batch_size=0)


def test_multihost_striping(tmp_path):
    """Training suppliers stripe files over processes; validation
    suppliers keep every file; a starved stripe (processes > files) falls
    back to the full set; a half-given pair raises, as in JAX."""
    for i in range(5):
        save(tmp_path / f"img{i}.png", (8, 8, 3))
    s0 = ImageFolderSupplier(str(tmp_path), shuffle=True, crop=(4, 4),
                             process_index=0, process_count=2)
    s1 = ImageFolderSupplier(str(tmp_path), shuffle=True, crop=(4, 4),
                             process_index=1, process_count=2)
    assert len(s0.files) == 3 and len(s1.files) == 2
    assert not set(s0.files) & set(s1.files)
    assert sorted(s0.files + s1.files) == \
        sorted(shard_files_for_host(s0.files + s1.files, 0, 1))
    j0 = jdata.ImageFolderSupplier(str(tmp_path), shuffle=True, crop=(4, 4),
                                   process_index=0, process_count=2)
    assert s0.files == j0.files
    val = ImageFolderSupplier(str(tmp_path), shuffle=False, process_index=1,
                              process_count=2)
    assert len(val.files) == 5
    starved = ImageFolderSupplier(str(tmp_path), shuffle=True, crop=(4, 4),
                                  process_index=7, process_count=8)
    assert len(starved.files) == 5
    assert len(ImageFolderSupplier(str(tmp_path)).files) == 5  # one process
    with pytest.raises(ValueError, match="both"):
        ImageFolderSupplier(str(tmp_path), process_index=1)


def test_buffer_shutdown_never_wedges(tmp_path):
    """close() with a full queue and an unread sentinel lets the worker
    exit, and next_batch() after close() returns None."""
    for i in range(6):
        save(tmp_path / f"img{i}.png", (8, 8, 3))
    sup = ImageFolderSupplier(str(tmp_path), crop=None, shuffle=False)
    buf = PrefetchBuffer(sup, depth=1, batch_size=1)
    time.sleep(0.3)   # the worker fills the queue and reaches the sentinel
    buf.close()
    buf._thread.join(timeout=5.0)
    assert not buf._thread.is_alive()
    assert buf.next_batch() is None


def test_buffer_drains_before_ending(tmp_path):
    """A sequential stream ends with every batch delivered and then None:
    the batches the worker queued before it exited are drained."""
    for i in range(4):
        save(tmp_path / f"img{i}.png", (8, 8, 3))
    sup = ImageFolderSupplier(str(tmp_path), crop=None, shuffle=False)
    buf = PrefetchBuffer(sup, depth=8, batch_size=2)
    buf._thread.join(timeout=5.0)
    got = [buf.next_batch() for _ in range(3)]
    assert [None if g is None else g.shape for g in got] == \
        [(2, 8, 8, 3), (2, 8, 8, 3), None]


def test_supplier_pixels_roundtrip_and_crops_are_windows(tmp_path):
    """The sequential supplier round-trips the saved pixels, and every
    random crop is a window of the source image."""
    h, w = 40, 56
    img = np.zeros((h, w, 3), np.uint8)
    img[..., 0] = np.arange(h)[:, None]
    img[..., 1] = np.arange(w)[None, :]
    img[..., 2] = 128
    d = tmp_path / "ti"
    d.mkdir()
    save_image_u8(str(d / "g.png"), img)
    f32 = img.astype(np.float32) / 255.0
    got = next(iter(ImageFolderSupplier(str(d), shuffle=False, crop=None)))
    assert got.tobytes() == f32.tobytes()
    it = iter(ImageFolderSupplier(str(d), crop=(16, 16), shuffle=True,
                                  seed=3))
    for _ in range(4):
        c = next(it)
        assert c.shape == (16, 16, 3)
        y0 = round(float(c[0, 0, 0]) * 255.0)
        x0 = round(float(c[0, 0, 1]) * 255.0)
        assert c.tobytes() == np.ascontiguousarray(
            f32[y0:y0 + 16, x0:x0 + 16]).tobytes()
