"""Training data: the synthetic task, the host loader and the dataset on
the device (the port of the JAX package's ``PrefetchLoader``: its host
epoch, and its device path, data/pipeline.py:89-187 and :310-326).

``HostLoader`` yields one epoch of (A, B) batches with independent
per-domain shuffles (unpaired training, ref dataset.py:24-35). Datasets
are arrays of file paths, decoded through the decoded-sample cache
(``data/cache.py``) by a thread pool, or arrays already decoded (the
synthetic task, the car sweeps). A thread decodes ahead of the step into
a bounded queue and copies each batch into pinned memory; the consumer
moves it to the card with ``non_blocking=True``. A file that fails to
decode is skipped (ref dataset.py:44-46) and remembered by the cache, so
its batch comes out smaller.

``DeviceDataset`` decodes both domains once, through the loader's cache,
into f32 tensors on the device, and gathers each batch there by index:
no image crosses from the host after the build. A file that fails to
decode takes a substitute image drawn from (seed, domain, index), so the
counts stay fixed. ``fits_device_budget`` says whether the trainer keeps
it on the card: both domains within DEVICE_BUDGET_SHARE of the card's
memory, as the JAX package's rule takes 30% of the device's
``bytes_limit``.

Under data parallelism each host takes ``rank_shard`` of both domains, and
each of its ranks builds its loader and dataset over the host's shard and
takes its ``rows`` (``host_rows``) of every batch: the ranks of one host
together take the batches that one process takes.

Each epoch's two permutations are drawn from (seed, epoch)
(``epoch_perms``), so a resumed run sees the batches the uninterrupted
run saw, and the loader and the dataset give the same batches; ``skip``
starts an epoch at a batch index without decoding the batches before it.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from .cache import STATUS_OK, STATUS_UNKNOWN, DecodedCache, cache_enabled
from .preprocess import decode_image

PREFETCH = 3  # batches the decode thread keeps ready
DEVICE_BUDGET_SHARE = 0.3  # of the card's memory, for the decoded dataset
DECODE_CHUNK = 256  # samples a decode batch of the dataset's build


def synthetic_pair(n: int, image_size: int, seed: int = 0):
    """Deterministic random image pairs (N,H,W,3) f32 in [0,1)."""
    rng = np.random.RandomState(seed)
    a = rng.rand(n, image_size, image_size, 3).astype(np.float32)
    b = rng.rand(n, image_size, image_size, 3).astype(np.float32)
    return a, b


def is_paths(data) -> bool:
    return len(data) > 0 and isinstance(
        np.asarray(data).ravel()[0], (str, np.str_, bytes))


def rank_shard(data, rank: int, world: int):
    """Shard ``rank`` of ``world`` of ``data`` (a host's, JAX
    train/loop.py:241-260): every world-th sample from ``rank`` on,
    truncated to len(data) // world, so that every shard has as many
    batches."""
    data = np.asarray(data)
    per = len(data) // world
    if per == 0:
        raise ValueError(f"{len(data)} samples for {world} ranks: every rank needs one")
    return data[rank::world][:per]


def host_rows(batch_size: int, part: int, parts: int) -> slice:
    """Part ``part`` of ``parts`` of a host's batch of ``batch_size`` rows: a
    rank's rows, as a ``parts``-device mesh splits the batch (JAX
    train/loop.py:352-375: ``--batch_size`` is a host's batch)."""
    if batch_size % parts:
        raise SystemExit(f"--batch_size {batch_size} is one host's batch and must "
                         f"split evenly over its {parts} ranks")
    per = batch_size // parts
    return slice(part * per, (part + 1) * per)


def epoch_perms(seed: int, epoch: int, n_a: int, n_b: int):
    """Epoch ``epoch``'s independent permutations of the two domains."""
    rng = np.random.default_rng([seed, epoch])
    return rng.permutation(n_a), rng.permutation(n_b)


class HostLoader:
    """Per-epoch iterator of (A, B) NHWC f32 batches on ``device``; the last
    partial batch is dropped.

    data_A/data_B: arrays of file paths, or decoded (N,H,W,3) f32 arrays.
    domain_A/domain_B: the decode-time domain tags ('A', 'B' or None).
    ``rows``: the rows of each batch this loader yields (a rank's part of a
    host's batch; all where None).
    ``waits`` collects the seconds the consumer waited for each batch.
    """

    def __init__(self, data_A, data_B, batch_size: int, image_size: int,
                 device, *, domain_A: Optional[str] = None,
                 domain_B: Optional[str] = None, seed: int = 0,
                 workers: Optional[int] = None, rows: Optional[slice] = None):
        self.data_A, self.data_B = np.asarray(data_A), np.asarray(data_B)
        self.batch_size, self.image_size = batch_size, image_size
        self.rows = rows or slice(None)
        self.device = torch.device(device)
        self.domains = (domain_A, domain_B)
        self.seed = seed
        self.paths = (is_paths(self.data_A), is_paths(self.data_B))
        # PIL's decode and cv2's ops release the GIL, so threads scale.
        self.workers = max(1, workers or min(8, os.cpu_count() or 1))
        self._pool = None
        self.caches = [None, None]
        if cache_enabled():
            try:
                self.caches = [DecodedCache(d, dom, image_size) if p else None
                               for d, dom, p in zip((self.data_A, self.data_B),
                                                    self.domains, self.paths)]
            except OSError as e:  # larger than the free disk: run uncached
                print(f"디코딩 캐시 비활성화: {e}")
                self.caches = [None, None]
        self.waits: list[float] = []

    @property
    def n_batches(self) -> int:
        return min(len(self.data_A), len(self.data_B)) // self.batch_size

    def _decode_paths(self, paths, domain, cache) -> list:
        """Decode ``paths`` through ``cache``: one array per path, None where
        the decode failed (now or in an earlier run)."""
        out = [None] * len(paths)
        missing = []
        for j, p in enumerate(paths):
            st, arr = cache.load(p) if cache is not None else (STATUS_UNKNOWN, None)
            if st == STATUS_OK:
                out[j] = arr
            elif st == STATUS_UNKNOWN:
                missing.append(j)

        def work(j):
            return j, decode_image(paths[j], domain, self.image_size, on_error="none")

        if self.workers > 1 and len(missing) > 1:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=self.workers)
            results = self._pool.map(work, missing)
        else:
            results = map(work, missing)
        for j, arr in results:
            out[j] = arr
            if cache is not None:
                cache.store(paths[j], arr)
        return out

    def _host_batch(self, data, k: int, idx) -> np.ndarray:
        if not self.paths[k]:
            return np.ascontiguousarray(data[idx], np.float32)
        arrs = [a for a in self._decode_paths([str(p) for p in data[idx]],
                                             self.domains[k], self.caches[k])
                if a is not None]
        if not arrs:
            raise ValueError("유효한 이미지가 없습니다.")
        return np.stack(arrs)

    def _pinned(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        return t.pin_memory() if self.device.type == "cuda" else t

    def epoch(self, epoch: int, skip: int = 0):
        """Yield epoch ``epoch``'s batches from batch index ``skip`` on."""
        pa, pb = epoch_perms(self.seed, epoch, len(self.data_A), len(self.data_B))
        q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def put(item) -> bool:
            # A consumer that leaves mid-epoch (a SIGTERM return, an error)
            # must not leave this thread blocked on a full queue.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.25)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                bs = self.batch_size
                for i in range(skip, self.n_batches):
                    if stop.is_set():
                        return
                    sl = slice(i * bs, (i + 1) * bs)
                    item = (self._pinned(self._host_batch(self.data_A, 0, pa[sl][self.rows])),
                            self._pinned(self._host_batch(self.data_B, 1, pb[sl][self.rows])))
                    if not put(item):
                        return
                put(None)
            except Exception as e:  # noqa: BLE001 - raised in the consumer
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                self.waits.append(time.perf_counter() - t0)
                if item is None:
                    self.waits.pop()
                    break
                if isinstance(item, Exception):
                    raise item
                yield tuple(x.to(self.device, non_blocking=True) for x in item)
        finally:
            stop.set()
            t.join()
            for c in self.caches:
                if c is not None:
                    c.flush()

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None


def dataset_bytes(n_a: int, n_b: int, image_size: int) -> int:
    """Both decoded domains in f32."""
    return (n_a + n_b) * image_size * image_size * 3 * 4


def fits_device_budget(n_a: int, n_b: int, image_size: int, device) -> bool:
    """Whether both decoded domains fit DEVICE_BUDGET_SHARE of the card's
    total memory (``torch.cuda.mem_get_info``)."""
    total = torch.cuda.mem_get_info(torch.device(device))[1]
    return dataset_bytes(n_a, n_b, image_size) <= DEVICE_BUDGET_SHARE * total


class DeviceDataset:
    """Both domains of ``loader`` decoded once into (N, H, W, 3) f32
    tensors on its device (``data``); the batches of an epoch gathered
    there by the loader's (seed, epoch) order, its ``rows`` of each."""

    def __init__(self, loader: HostLoader):
        self.device = loader.device
        self.batch_size, self.seed, self.rows = loader.batch_size, loader.seed, loader.rows
        self.n_batches = loader.n_batches
        self.data = tuple(self._build(loader, k) for k in (0, 1))
        for c in loader.caches:
            if c is not None:
                c.flush()

    def _build(self, loader: HostLoader, k: int) -> torch.Tensor:
        data = (loader.data_A, loader.data_B)[k]
        if not loader.paths[k]:
            return torch.from_numpy(np.ascontiguousarray(data, np.float32)).to(self.device)
        size = loader.image_size
        out = torch.empty((len(data), size, size, 3), dtype=torch.float32, device=self.device)
        paths = [str(p) for p in data]
        for i in range(0, len(paths), DECODE_CHUNK):
            arrs = loader._decode_paths(paths[i:i + DECODE_CHUNK], loader.domains[k],
                                        loader.caches[k])
            arrs = [a if a is not None else np.random.default_rng(
                        [self.seed, k, i + j]).random((size, size, 3), dtype=np.float32)
                    for j, a in enumerate(arrs)]
            out[i:i + len(arrs)].copy_(torch.from_numpy(np.stack(arrs)))
        return out

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.data)

    def epoch_rows(self, epoch: int):
        """Epoch ``epoch``'s index rows into each domain, (n_batches,
        rows) int64 each: the loader's batches."""
        pa, pb = epoch_perms(self.seed, epoch, len(self.data[0]), len(self.data[1]))
        n = self.n_batches * self.batch_size
        return tuple(np.ascontiguousarray(p[:n].reshape(self.n_batches, -1)[:, self.rows],
                                          np.int64) for p in (pa, pb))

    def gather(self, idx_A, idx_B):
        """The batch of the index rows ``idx_A``, ``idx_B``, on the device."""
        def take(data, idx):
            idx = torch.from_numpy(np.asarray(idx, np.int64))
            if self.device.type == "cuda":
                idx = idx.pin_memory().to(self.device, non_blocking=True)
            return data.index_select(0, idx)
        return take(self.data[0], idx_A), take(self.data[1], idx_B)

    def epoch(self, epoch: int, skip: int = 0):
        """Yield epoch ``epoch``'s batches from batch index ``skip`` on."""
        ia, ib = self.epoch_rows(epoch)
        for i in range(skip, self.n_batches):
            yield self.gather(ia[i], ib[i])
