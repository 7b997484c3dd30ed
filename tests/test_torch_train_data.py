"""The port's training feed (`train.data.CropPipeline`) against the JAX
package's, byte for byte: the same folder, seed, crop and batch give the
same batches whatever the worker counts, in uint8 and float32, with an
unreadable file and an image smaller than the crop in the folder.  Every
pipeline is closed in a ``finally``: it runs worker threads."""

import numpy as np
import pytest

from rusty_sr_tpu.train.data import CropPipeline as JCropPipeline
from rusty_sr_tpu_torch.train.data import (CropPipeline, list_images,
                                           shard_files_for_host)
from rusty_sr_tpu_torch.utils.imageio import save_image_u8


def make_folder(path, n=5, hw=(40, 52), bad=False, small=False):
    """Images whose pixels encode (file, y, x): R = 10 * file, G = y,
    B = x; plus, on request, a truncated PNG and a 9 x 11 image."""
    h, w = hw
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    for i in range(n):
        img = np.stack([np.full((h, w), 10 * i), yy, xx],
                       axis=-1).astype(np.uint8)
        save_image_u8(str(path / f"img{i}.png"), img)
    if bad:
        save_image_u8(str(path / "bad.png"), np.zeros((20, 20, 3), np.uint8))
        data = (path / "bad.png").read_bytes()
        (path / "bad.png").write_bytes(data[: len(data) // 2])
    if small:
        save_image_u8(str(path / "small.png"), np.random.default_rng(1)
                      .integers(0, 256, (9, 11, 3), dtype=np.uint8))
    return str(path)


def collect(cls, folder, n, **kw):
    pipe = cls(folder, **kw)
    try:
        return np.stack([pipe.next_batch().copy() for _ in range(n)])
    finally:
        pipe.close()


CASES = [(np.uint8, 1, False, False), (np.uint8, 4, True, True),
         (np.float32, 1, True, False), (np.float32, 4, False, True)]


@pytest.mark.parametrize("dtype,workers,bad,small", CASES,
                         ids=["u8-w1", "u8-w4-bad-small", "f32-w1-bad",
                              "f32-w4-small"])
def test_batches_equal_jax(tmp_path, dtype, workers, bad, small):
    folder = make_folder(tmp_path, bad=bad, small=small)
    kw = dict(crop=(16, 16), batch_size=3, seed=7, out_dtype=dtype)
    got = collect(CropPipeline, folder, 8, workers=workers, **kw)
    want = collect(JCropPipeline, folder, 8, workers=2, **kw)
    assert got.dtype == np.dtype(dtype) and got.shape == (8, 3, 16, 16, 3)
    assert got.tobytes() == want.tobytes()


def test_worker_counts_and_dtypes_agree(tmp_path):
    folder = make_folder(tmp_path)
    kw = dict(crop=(28, 28), batch_size=3, seed=3)
    a = collect(CropPipeline, folder, 6, workers=1, **kw)
    b = collect(CropPipeline, folder, 6, workers=8, **kw)
    u = collect(CropPipeline, folder, 6, workers=3, out_dtype=np.uint8, **kw)
    assert a.tobytes() == b.tobytes()
    np.testing.assert_array_equal(a, u.astype(np.float32)
                                  * np.float32(1 / 255.0))


def test_crops_are_windows_and_bad_files_skip(tmp_path):
    folder = make_folder(tmp_path, n=3, bad=True)
    pipe = CropPipeline(folder, crop=(16, 16), batch_size=4, seed=1,
                        workers=4, out_dtype=np.uint8)
    try:
        for _ in range(6):
            for crop in pipe.next_batch().astype(np.int32):
                fid, y0, x0 = crop[0, 0]
                assert fid % 10 == 0 and fid // 10 < 3
                yy, xx = np.meshgrid(np.arange(16), np.arange(16),
                                     indexing="ij")
                assert (crop[..., 0] == fid).all()
                assert (crop[..., 1] == y0 + yy).all()
                assert (crop[..., 2] == x0 + xx).all()
        st = pipe.cache_stats()
    finally:
        pipe.close()
    assert st["bad"] == 1 and st["cached"] == 3


def test_all_unreadable_raises_and_refusals(tmp_path):
    (tmp_path / "a.png").write_bytes(b"\x89PNG\r\n\x1a\nnot a png")
    pipe = CropPipeline(str(tmp_path), crop=(8, 8), batch_size=1, workers=2)
    try:
        with pytest.raises(RuntimeError, match="could be decoded"):
            pipe.next_batch()
    finally:
        pipe.close()
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ValueError, match="no images"):
        CropPipeline(str(empty))
    with pytest.raises(ValueError, match="batch_size"):
        CropPipeline(str(tmp_path), batch_size=0)
    with pytest.raises(ValueError, match="out_dtype"):
        CropPipeline(str(tmp_path), out_dtype=np.float16)
    with pytest.raises(ValueError, match="process_index"):
        CropPipeline(str(tmp_path), shard_across_hosts=True)


def test_close_never_wedges(tmp_path):
    pipe = CropPipeline(make_folder(tmp_path), crop=(16, 16), batch_size=2,
                        workers=4)
    try:
        pipe.next_batch()
    finally:
        pipe.close()
    for t in pipe._threads:
        t.join(timeout=5)
        assert not t.is_alive()


def test_shard_files_for_host(tmp_path):
    files = [f"f{i}" for i in range(7)]
    assert shard_files_for_host(files, 0, 1) == files
    parts = [shard_files_for_host(files, i, 3) for i in range(3)]
    assert sorted(sum(parts, [])) == sorted(files)
    assert parts[1] == ["f1", "f4"]
    with pytest.raises(ValueError):
        shard_files_for_host(files, 3, 3)
    folder = make_folder(tmp_path, n=6)
    seen = []
    for i in range(2):
        pipe = CropPipeline(folder, crop=(16, 16), batch_size=2, workers=2,
                            shard_across_hosts=True, process_index=i,
                            process_count=2, out_dtype=np.uint8)
        try:
            seen.append({int(b[0, 0, 0]) // 10 for _ in range(4)
                         for b in pipe.next_batch()})
        finally:
            pipe.close()
    assert seen[0] and seen[1] and not (seen[0] & seen[1])
    assert list_images(folder) == sorted(list_images(folder))
