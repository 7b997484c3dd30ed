"""Image folders and the training feed: `list_images`, `CropPipeline`,
and the reference-shaped `ImageFolderSupplier` and `PrefetchBuffer`,
copies of `rusty_sr_tpu/train/data.py`'s.

`CropPipeline` is the feed both training entry points use (the CLI's
``train`` and `api.train_folder`): a decoded-image cache and a pool of
crop workers that emits the same batches, byte for byte, for any worker
count.  `ImageFolderSupplier` and `PrefetchBuffer` are the reference's
``ImageFolderSupplier`` and ``Buffer`` pair (one decode per crop on one
thread), for API users who feed `train.loop.train_loop` themselves.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, List, Optional

import numpy as np

from rusty_sr_tpu_torch.utils.imageio import DECODE_ERRORS, load_image_u8

_IMG_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".gif", ".tif", ".tiff", ".webp"}


def list_images(folder: str, recurse: bool = False) -> List[str]:
    """Image files in `folder` (optionally recursive), sorted for determinism."""
    out: List[str] = []
    if recurse:
        for root, _dirs, files in os.walk(folder):
            out += [os.path.join(root, f) for f in files
                    if os.path.splitext(f)[1].lower() in _IMG_EXTS]
    else:
        out = [os.path.join(folder, f) for f in os.listdir(folder)
               if os.path.splitext(f)[1].lower() in _IMG_EXTS]
    return sorted(out)


def shard_files_for_host(files, process_index: int, process_count: int):
    """The stripe of ``files`` that process ``process_index`` of
    ``process_count`` reads (every ``process_count``-th file); one
    process reads them all.  The JAX package reads the two numbers from
    `jax.process_index/count` when they are not given; here they are
    always given."""
    if not 0 <= process_index < max(process_count, 1):
        raise ValueError(f"process_index {process_index} is not in "
                         f"[0, {process_count})")
    if process_count <= 1:
        return list(files)
    return [f for i, f in enumerate(files)
            if i % process_count == process_index]


class ImageFolderSupplier:
    """Streams (H,W,3) f32 images, optionally random-cropped: the JAX
    package's, which crops the same windows from the same seed.

    crop=None mirrors `Cropping::None` (whole image); crop=(h,w) mirrors
    `Cropping::Random{width,height}` (reference src/main.rs:187,222).
    Images smaller than the crop are edge-padded up to the crop size.
    ``shuffle`` suppliers (training) stripe the files over processes by
    default (``shard_across_hosts``), as `shard_files_for_host` does with
    ``process_index`` and ``process_count`` (both, or neither: one
    process); sequential ones (validation) keep every file, so that
    every process reports the same PSNR.
    """

    def __init__(self, folder: str, recurse: bool = False,
                 crop: Optional[tuple] = None, shuffle: bool = True,
                 seed: int = 0, shard_across_hosts: Optional[bool] = None,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        if (process_index is None) != (process_count is None):
            # A half-specified pair would stripe with the wrong index or
            # count: duplicated or starved processes.
            raise ValueError("pass both process_index and process_count, "
                             "or neither")
        self.files = list_images(folder, recurse)
        if not self.files:
            raise ValueError(f"no images found in {folder!r}")
        if shard_across_hosts is None:
            shard_across_hosts = shuffle
        if shard_across_hosts and process_count is not None:
            stripe = shard_files_for_host(self.files, process_index,
                                          process_count)
            # a stripe can be empty when processes > files; duplicate
            # rather than starve the process (training still sees every
            # file)
            self.files = stripe if stripe else self.files
        self.crop = crop
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)

    def epoch_size(self) -> int:
        return len(self.files)

    def _crop(self, img: np.ndarray) -> np.ndarray:
        ch, cw = self.crop
        h, w, _ = img.shape
        if h < ch or w < cw:
            img = np.pad(img, ((0, max(0, ch - h)), (0, max(0, cw - w)),
                               (0, 0)), mode="edge")
            h, w, _ = img.shape
        y = int(self.rng.integers(0, h - ch + 1))
        x = int(self.rng.integers(0, w - cw + 1))
        return img[y:y + ch, x:x + cw]

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            order = np.arange(len(self.files))
            if self.shuffle:
                self.rng.shuffle(order)
            yielded = 0
            for i in order:
                try:
                    img = load_image_u8(self.files[i]).astype(
                        np.float32) / 255.0
                except DECODE_ERRORS:
                    continue  # unreadable file: skip, like a decode error
                yielded += 1
                yield self._crop(img) if self.crop is not None else img
            if yielded == 0:
                # Every file failed to decode: raising beats spinning on
                # the same broken folder forever.
                raise RuntimeError(
                    f"none of the {len(self.files)} image files in the "
                    "folder could be decoded")
            if not self.shuffle:
                return  # a sequential supplier is one epoch (validation)


class PrefetchBuffer:
    """Background-thread prefetch of batched crops (the reference's
    ``Buffer``, src/main.rs:188: depth 128 for training)."""

    def __init__(self, supplier: ImageFolderSupplier, depth: int = 128,
                 batch_size: int = 1):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.supplier = supplier
        self.batch_size = batch_size
        self.q: "queue.Queue[np.ndarray]" = queue.Queue(
            maxsize=max(1, depth // batch_size))
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Blocking put that honours close(); False if stopped first."""
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        batch = []
        try:
            for img in iter(self.supplier):
                if self._stop.is_set():
                    return
                batch.append(img)
                if len(batch) == self.batch_size:
                    arr = np.stack(batch)
                    batch = []
                    if not self._put(arr):
                        return
        except BaseException as e:  # noqa: B036 — any worker crash
            # (an unreadable folder, unstackable shapes) and
            # BaseExceptions (SystemExit from a hook, a signal landing on
            # this thread) must reach the consumer: a swallowed one would
            # read as a clean end of the stream and cut training short.
            self._error = e
        # The end-of-stream sentinel (sequential suppliers, or an error),
        # with the same stop-aware put, so shutdown never wedges on a full
        # queue.  A final partial batch is dropped: the training step
        # takes one batch shape.
        self._put(None)

    def next_batch(self) -> Optional[np.ndarray]:
        """The next batch, or None at the end of the stream or after
        close().  A supplier's error (e.g. an unreadable training folder)
        is raised again here, on the consumer's thread."""
        while not self._stop.is_set():
            try:
                item = self.q.get(timeout=0.5)
            except queue.Empty:
                if not self._thread.is_alive():
                    # Between the Empty and this liveness check the worker
                    # may have queued its last batch (and the sentinel)
                    # and exited: drain before concluding the stream
                    # ended, or real batches are dropped.
                    try:
                        item = self.q.get_nowait()
                    except queue.Empty:
                        item = None  # the worker died without a sentinel
                else:
                    continue
            if item is None and self._error is not None:
                raise self._error
            return item
        return None

    def close(self):
        self._stop.set()


class CropPipeline:
    """Production training feed: decoded-image cache + N-worker crop pool.

    A copy of `rusty_sr_tpu/train/data.py::CropPipeline`: the batch
    stream is byte-identical to the JAX package's for the same folder,
    seed, crop and batch, whatever the worker counts.

    - **Decoded-image cache**: each file is decoded ONCE to (H,W,3) u8
      and kept in RAM up to ``cache_bytes`` (u8 is 4x smaller than f32;
      crops convert to f32 only at batch assembly).  Past the budget,
      files decode on use.  A typical 800-image DIV2K-class folder is
      ~4 GB of u8 — it fits; after the first epoch the pipeline is pure
      memcpy + f32 convert.
    - **Deterministic crop plan**: ONE RNG stream generates, per global
      crop index k, (file, u_y, u_x in [0,1)) — epoch shuffles included.
      Workers execute plan entries concurrently and a bounded
      reassembly window re-emits them in k order, so the batch stream
      is bit-identical for ANY worker count (seed -> same batches; the
      determinism knob survives parallelism).
    - **N workers**: PIL decode and numpy slicing/convert release the
      GIL, so threads suffice (no fork/pickle cost).

    ``next_batch()`` yields (B,ch,cw,3) f32 (or u8) batches (never None
    — the shuffle stream is infinite), ``close()`` stops the workers.
    Unreadable files are skipped deterministically (their plan entries
    are dropped in k order); if every file fails to decode,
    ``next_batch`` raises.
    """

    def __init__(self, folder: str, *, recurse: bool = False,
                 crop: tuple = (192, 192), batch_size: int = 4,
                 seed: int = 0, workers: Optional[int] = None,
                 cache_bytes: int = 6 << 30,
                 out_dtype=np.float32,
                 shard_across_hosts: bool = False,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if np.dtype(out_dtype) not in (np.dtype(np.float32),
                                       np.dtype(np.uint8)):
            raise ValueError(f"out_dtype must be float32 or uint8, "
                             f"got {out_dtype}")
        self.out_dtype = np.dtype(out_dtype)
        self.files = list_images(folder, recurse)
        if not self.files:
            raise ValueError(f"no images found in {folder!r}")
        if shard_across_hosts:
            if process_index is None or process_count is None:
                raise ValueError("shard_across_hosts needs process_index "
                                 "and process_count")
            stripe = shard_files_for_host(self.files, process_index,
                                          process_count)
            self.files = stripe if stripe else self.files
        self.crop = crop
        self.batch_size = batch_size
        if workers is None:
            workers = max(2, min(16, os.cpu_count() or 4))
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self.workers = workers
        self._cache: dict = {}
        self._cache_used = 0
        self._cache_bytes = cache_bytes
        self._cache_lock = threading.Lock()
        self._file_locks: dict = {}
        self._bad = set()           # indices that failed to decode
        self._rng = np.random.default_rng(seed)
        # Reassembly window: bounds out-of-order memory at ~110 KB/crop.
        self._window = max(4 * batch_size, 4 * workers, 64)
        self._plan_q: "queue.Queue[tuple]" = queue.Queue(maxsize=self._window)
        self._done: dict = {}       # k -> (H,W,3) u8 crop | None (skip)
        self._done_cv = threading.Condition()
        self._next_emit = 0
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._threads = [threading.Thread(target=self._plan_worker,
                                          daemon=True)]
        self._threads += [threading.Thread(target=self._crop_worker,
                                           daemon=True)
                          for _ in range(workers)]
        for t in self._threads:
            t.start()

    # ---- plan generation (single RNG stream => worker-count invariant)
    def _plan_worker(self):
        k = 0
        nf = len(self.files)
        try:
            while not self._stop.is_set():
                order = self._rng.permutation(nf)
                for i in order:
                    # 2 draws per entry ALWAYS (even for files later
                    # found bad): the plan stream must not depend on
                    # decode outcomes discovered concurrently.
                    uy, ux = self._rng.random(), self._rng.random()
                    item = (k, int(i), uy, ux)
                    k += 1
                    while not self._stop.is_set():
                        try:
                            self._plan_q.put(item, timeout=0.2)
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        return
        except BaseException as e:  # noqa: B036 — propagate to consumer
            self._error = e
            with self._done_cv:
                self._done_cv.notify_all()

    def _load(self, idx: int) -> Optional[np.ndarray]:
        """Decoded (H,W,3) u8 for file idx — cache-first, decode-once."""
        img = self._cache.get(idx)
        if img is not None:
            return img
        if idx in self._bad:
            return None
        with self._cache_lock:
            lock = self._file_locks.setdefault(idx, threading.Lock())
        with lock:
            img = self._cache.get(idx)
            if img is not None:
                return img
            if idx in self._bad:
                return None
            try:
                img = np.ascontiguousarray(load_image_u8(self.files[idx]))
            except DECODE_ERRORS:
                self._bad.add(idx)
                return None
            with self._cache_lock:
                if self._cache_used + img.nbytes <= self._cache_bytes:
                    self._cache[idx] = img
                    self._cache_used += img.nbytes
            return img

    def _crop_worker(self):
        ch, cw = self.crop
        try:
            while not self._stop.is_set():
                try:
                    k, idx, uy, ux = self._plan_q.get(timeout=0.2)
                except queue.Empty:
                    continue
                img = self._load(idx)
                if img is None:
                    out = None
                else:
                    h, w, _ = img.shape
                    if h < ch or w < cw:
                        img = np.pad(img, ((0, max(0, ch - h)),
                                           (0, max(0, cw - w)), (0, 0)),
                                     mode="edge")
                        h, w, _ = img.shape
                    y = int(uy * (h - ch + 1))
                    x = int(ux * (w - cw + 1))
                    out = np.ascontiguousarray(img[y:y + ch, x:x + cw])
                with self._done_cv:
                    # Back-pressure: cap the reassembly window.  The
                    # worker holding the next-needed index always
                    # proceeds (plan entries are pulled FIFO, so the
                    # minimal outstanding k is in a worker, never parked
                    # behind this wait -> no deadlock).
                    while (len(self._done) >= self._window
                           and k != self._next_emit
                           and not self._stop.is_set()):
                        self._done_cv.wait(timeout=0.5)
                    self._done[k] = out
                    self._done_cv.notify_all()
        except BaseException as e:  # noqa: B036 — propagate to consumer
            self._error = e
            with self._done_cv:
                self._done_cv.notify_all()

    def _next_crop(self) -> np.ndarray:
        """Next good crop in plan order (u8); raises on pipeline error
        or when every file proves undecodable."""
        while True:
            with self._done_cv:
                while (self._next_emit not in self._done
                       and self._error is None
                       and not self._stop.is_set()):
                    self._done_cv.wait(timeout=0.5)
                if self._error is not None:
                    raise self._error
                if self._stop.is_set():
                    raise RuntimeError("CropPipeline is closed")
                out = self._done.pop(self._next_emit)
                self._next_emit += 1
                self._done_cv.notify_all()   # wake workers on window space
            if out is not None:
                return out
            if len(self._bad) >= len(self.files):
                raise RuntimeError(
                    f"none of the {len(self.files)} image files in the "
                    "folder could be decoded")

    def next_batch(self) -> np.ndarray:
        """(B,ch,cw,3) batch — blocking, stream is infinite.

        ``out_dtype=float32`` (default): sRGB codes in [0,1].
        ``out_dtype=uint8``: raw codes — 4x less host->device transfer;
        the train step converts on the device with the same *(1/255) the
        host would use (bit-identical batches, `train.loop.loss_fn`).
        """
        ch, cw = self.crop
        out = np.empty((self.batch_size, ch, cw, 3), self.out_dtype)
        for j in range(self.batch_size):
            if self.out_dtype == np.uint8:
                out[j] = self._next_crop()
            else:
                np.multiply(self._next_crop(), np.float32(1 / 255.0),
                            out=out[j], casting="unsafe")
        return out

    def cache_stats(self) -> dict:
        return {"files": len(self.files), "cached": len(self._cache),
                "cache_bytes": self._cache_used, "bad": len(self._bad)}

    def close(self):
        self._stop.set()
        with self._done_cv:
            self._done_cv.notify_all()
