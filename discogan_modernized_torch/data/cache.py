"""Decoded-sample cache: preprocessed images kept on disk (the port of the
JAX package's ``data/cache.py``).

The reference decodes and preprocesses every image on every epoch (ref
image_translation.py:321-333). Preprocessing is a pure function of the
file's bytes, the domain and the size, so the first decode of each sample
is written to a disk-backed float32 memmap named by a fingerprint of the
dataset (paths, file sizes and mtimes, domain, image size), and every later
read, in later epochs and later runs over the same files, is a memmap read
that the page cache serves. The cache stores the exact float32 output, so
a hit gives the bits a decode would.

One flat memmap a dataset (``<digest>.dat``, with a status byte a sample
in ``<digest>.status``) avoids per-file opens in the hot loop. A sample
whose decode fails is remembered as failed and skipped from then on (ref
dataset.py:44-46) without reading the broken file again.

The port keeps its own cache, apart from the JAX package's: under
``build/data_cache/`` of the repository (DISCOGAN_TORCH_CACHE_DIR to move
it), with its own fingerprint tag. DISCOGAN_DATA_CACHE=0 turns it off; a
cache that would not fit the disk is not made.
"""

from __future__ import annotations

import hashlib
import json
import mmap
import os
import shutil
import time
from pathlib import Path
from typing import Optional

import numpy as np

STATUS_UNKNOWN = 0
STATUS_OK = 1
STATUS_FAILED = 2


def cache_root() -> Path:
    return Path(os.environ.get(
        "DISCOGAN_TORCH_CACHE_DIR",
        str(Path(__file__).resolve().parents[2] / "build" / "data_cache")))


def cache_enabled() -> bool:
    return os.environ.get("DISCOGAN_DATA_CACHE", "1") != "0"


def _fingerprint(paths, domain: Optional[str], image_size: int) -> str:
    h = hashlib.sha1()
    h.update(f"torch-v1|{domain}|{image_size}|{len(paths)}".encode())
    for p in paths:
        p = str(p)
        try:
            st = os.stat(p)
            h.update(f"{p}|{st.st_size}|{st.st_mtime_ns}".encode())
        except OSError:
            h.update(f"{p}|missing".encode())
    return h.hexdigest()[:20]


def _lock_stale(path: Path) -> bool:
    """A creation lock is stale when its owner's pid is dead, or when it is
    older than 600 s (pids are reused; a creator needs the lock only for one
    allocation). A lock without a pid falls back to 120 s."""
    try:
        txt = path.read_text().strip()
    except OSError:
        return False  # gone: not ours to steal
    try:
        age = time.time() - path.stat().st_mtime
    except OSError:
        return False
    if txt.isdigit():
        try:
            os.kill(int(txt), 0)
        except ProcessLookupError:
            return True
        except OSError:
            return False  # alive under another user
        return age > 600
    return age > 120


class DecodedCache:
    """Memmap of preprocessed samples for one (path list, domain, size).

    load(path)  -> (status, array or None); the array is a fresh copy.
    store(path, array or None) records a decoded sample or a failure.
    """

    # One msync of the data pages per this many stores, before their OK
    # flags are set: an OS crash can then never leave an OK flag over
    # unwritten data, and the cold path pays no flush a sample.
    SYNC_EVERY = 64

    def __init__(self, paths, domain: Optional[str], image_size: int,
                 root: Optional[Path] = None):
        self.paths = [str(p) for p in paths]
        self.index = {p: i for i, p in enumerate(self.paths)}
        self.image_size = image_size
        self.domain = domain
        n = len(self.paths)
        self.shape = (n, image_size, image_size, 3)
        self.nbytes = int(np.prod(self.shape)) * 4

        root = Path(root) if root else cache_root()
        digest = _fingerprint(self.paths, domain, image_size)
        self.data_path = root / f"{digest}.dat"
        self.status_path = root / f"{digest}.status"
        root.mkdir(parents=True, exist_ok=True)

        if not self._complete():
            free = shutil.disk_usage(root).free
            if self.nbytes + n > free * 0.8:
                raise OSError(
                    f"decoded-sample cache needs {(self.nbytes + n) / 1e9:.1f} GB, "
                    f"only {free / 1e9:.1f} GB free under {root}")
            self._create_locked(root, digest)
            self._evict_stale(root, digest)
        self.data = np.memmap(self.data_path, dtype=np.float32, mode="r+",
                              shape=self.shape)
        self.status = np.memmap(self.status_path, dtype=np.uint8, mode="r+",
                                shape=(n,))
        self._pending: list[int] = []  # stored, OK flag not yet set
        self._pending_set: set[int] = set()
        meta = root / f"{digest}.json"
        if not meta.exists():
            meta.write_text(json.dumps(self._identity()))

    def _identity(self) -> dict:
        return {"domain": self.domain, "image_size": self.image_size,
                "n": len(self.paths),
                "first_path": self.paths[0] if self.paths else None}

    def _complete(self) -> bool:
        """Both backing files exist at their final size."""
        try:
            return (self.data_path.stat().st_size == self.nbytes
                    and self.status_path.stat().st_size == len(self.paths))
        except OSError:
            return False

    def _create_locked(self, root: Path, digest: str) -> None:
        """Allocate the backing files once across processes. Creation is
        serialized by an exclusive-create lock, and never truncates: a
        second creator over existing files keeps the samples already
        there. A lock left by a dead creator is stolen by an atomic
        rename, and put back with os.link if it turns out to be live."""
        lock = root / f"{digest}.lock"
        deadline = time.time() + 900
        while not self._complete():
            try:
                fd = os.open(str(lock), os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o666)
                os.write(fd, str(os.getpid()).encode())
                os.close(fd)
            except FileExistsError:
                try:
                    if _lock_stale(lock):
                        grabbed = lock.with_suffix(f".lock.stale.{os.getpid()}")
                        try:
                            os.rename(lock, grabbed)
                        except OSError:
                            continue  # the creator finished, or another stealer won
                        if _lock_stale(grabbed):
                            grabbed.unlink(missing_ok=True)
                            continue
                        try:  # a live creator's lock: put it back
                            os.link(grabbed, lock)
                        except OSError:
                            pass  # a newer lock exists; leave it
                        grabbed.unlink(missing_ok=True)
                except OSError:
                    continue
                if time.time() > deadline:
                    raise OSError(f"timed out waiting for the cache creation lock {lock}")
                time.sleep(0.1)
                continue
            try:
                if not self._complete():
                    self._allocate()
            finally:
                try:
                    lock.unlink()
                except OSError:
                    pass
            return

    def _allocate(self) -> None:
        def size(path) -> int:
            try:
                return os.stat(path).st_size
            except OSError:
                return -1

        def extend(path, nbytes):  # O_CREAT without O_TRUNC, then ftruncate
            fd = os.open(str(path), os.O_CREAT | os.O_RDWR, 0o666)
            try:
                os.ftruncate(fd, nbytes)
            finally:
                os.close(fd)

        if size(self.data_path) != self.nbytes:
            # The data file is about to be made or resized: OK flags that
            # survived it would mark zeroed samples valid. Clear them, on
            # disk, before the new data file exists.
            try:
                fd = os.open(str(self.status_path), os.O_RDWR)
            except OSError:
                pass  # no status file yet: it is made zeroed below
            else:
                try:
                    os.write(fd, b"\x00" * len(self.paths))
                    os.fsync(fd)
                finally:
                    os.close(fd)
        extend(self.data_path, self.nbytes)
        extend(self.status_path, len(self.paths))

    def _evict_stale(self, root: Path, digest: str) -> None:
        """Delete older generations of the same dataset (same first path,
        domain, size and count): a touched source file changes the
        fingerprint, and the old memmap would otherwise stay forever."""
        ident = self._identity()
        for meta in root.glob("*.json"):
            if meta.stem == digest:
                continue
            try:
                other = json.loads(meta.read_text())
            except (OSError, ValueError):
                continue
            if all(other.get(k) == v for k, v in ident.items()):
                for suffix in (".dat", ".status", ".json", ".lock"):
                    try:
                        (root / (meta.stem + suffix)).unlink()
                    except OSError:
                        pass

    def load(self, path: str):
        i = self.index.get(str(path))
        if i is None:
            return STATUS_UNKNOWN, None
        st = int(self.status[i])
        if st != STATUS_OK and i in self._pending_set:
            st = STATUS_OK  # stored here, its flag awaiting the batch's sync
        if st == STATUS_OK:
            return st, np.array(self.data[i], copy=True)
        return st, None

    def store(self, path: str, arr: Optional[np.ndarray]) -> None:
        i = self.index.get(str(path))
        if i is None:
            return
        if arr is None:
            self.status[i] = STATUS_FAILED
            return
        self.data[i] = arr
        self._pending.append(i)
        self._pending_set.add(i)
        if len(self._pending) >= self.SYNC_EVERY:
            self._publish_pending()

    def _publish_pending(self) -> None:
        """msync the pending samples' data pages, then set their OK flags."""
        if not self._pending:
            return
        try:
            stride = self.data.strides[0]
            gran = mmap.ALLOCATIONGRANULARITY
            lo, hi = min(self._pending), max(self._pending)
            start = (lo * stride // gran) * gran
            end = min((hi + 1) * stride, self.data.nbytes)
            self.data.base.flush(start, end - start)
        except Exception:  # noqa: BLE001 - a full flush is as correct, only coarser
            self.data.flush()
        for i in self._pending:
            self.status[i] = STATUS_OK
        self._pending.clear()
        self._pending_set.clear()

    @property
    def hit_fraction(self) -> float:
        if not self.paths:
            return 1.0
        return float(np.mean(self.status != STATUS_UNKNOWN))

    def flush(self) -> None:
        self._publish_pending()
        self.data.flush()
        self.status.flush()
