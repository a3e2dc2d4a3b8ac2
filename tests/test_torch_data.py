"""The port's data path against the JAX package's, on the CPU:

- every resolver gives JAX's file lists and splits, on the fabricated tree
  of tests/test_resolvers.py (copied here), CelebA's without pandas, and
  get_task_data for every task both trainers take;
- decode_image and read_images give JAX's arrays bit for bit (the same
  cv2 path; the numpy path on a host without cv2), and shuffle_data;
- the port's own native library (its copy of native/discodata.cpp, built
  into build/native/) gives the JAX package's native output bit for bit;
- the decoded-sample cache (tests/test_cache.py's behaviours): hits are
  bit-identical and decode nothing, a changed file invalidates, failures
  are remembered, creation is race-safe and never truncates, a stale
  generation is evicted, lost data clears surviving flags, the opt-out;
  and the port's cache never shares the JAX package's files;
- the host loader: batches equal the decoded files in the epoch's order,
  bad files are skipped, ``skip=`` decodes nothing it skips, the two
  domains shuffle independently and each epoch's order is a function of
  (seed, epoch).
"""

import os
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
from PIL import Image

from discogan_modernized_tpu.data import preprocess as jax_pp
from discogan_modernized_tpu.data import resolvers as jax_res
from discogan_modernized_torch.data import pipeline as pl
from discogan_modernized_torch.data import preprocess as pp
from discogan_modernized_torch.data import resolvers as res
from discogan_modernized_torch.data.cache import DecodedCache
from discogan_modernized_torch.data.pipeline import HostLoader, epoch_perms
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture()
def fake_datasets(tmp_path, monkeypatch):
    """tests/test_resolvers.py's tree, with an edges2handbags split and a
    face_3d sweep beside it."""
    root = tmp_path / "datasets"
    rng = np.random.RandomState(0)

    def write_img(path, w=32, h=32):
        path.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(path)

    for split, n in (("train", 6), ("test", 3)):
        for i in range(n):
            write_img(root / "edges2shoes" / split / f"{i}_AB.jpg", w=512, h=256)
    for split, n in (("train", 4), ("test", 2)):
        for i in range(n):
            write_img(root / "edges2handbags" / split / f"hb{i}_AB.jpg", w=512, h=64)
    celeba = root / "celebA"
    (celeba / "img_align_celeba").mkdir(parents=True)
    names = [f"{i:06d}.jpg" for i in range(1, 11)]
    for n_ in names:
        write_img(celeba / "img_align_celeba" / n_)
    lines = ["10", "Male Smiling"]
    for i, n_ in enumerate(names):
        lines.append(f"{n_} {'1' if i % 2 == 0 else '-1'} {'1' if i < 5 else '-1'}")
    (celeba / "list_attr_celeba.txt").write_text("\n".join(lines) + "\n")
    for grp, n in (("actors", 5), ("actresses", 5)):
        for i in range(n):
            write_img(root / "facescrub" / grp / f"face_{i}.jpg")
    for item in ("tops", "hanbok"):
        for split in ("train", "test"):
            for i in range(3):
                write_img(root / "custom" / item / split / f"{i}.jpg")
    for az in range(0, 180, 20):
        write_img(root / "data" / "cars" / f"car_a_{az:03d}.png")
        write_img(root / "data" / "cars" / f"car_b_{az:03d}.png")
    for az in range(0, 360, 30):
        write_img(root / "rendered_chairs" / "chair1" / f"render_{az:03d}.png")
    for az in range(0, 180, 15):
        write_img(root / "PublicMM1" / "05_renderings" / "face1" / f"f_{az:03d}.png")
    monkeypatch.setenv("DISCOGAN_DATASETS_ROOT", str(root))
    return root


def same(a, b):
    """Equal file lists, or equal decoded arrays."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind in "fc":
        return a.dtype == b.dtype and np.array_equal(a, b)
    return [str(x) for x in a] == [str(x) for x in b]


@pytest.mark.parametrize("call", [
    ("get_edge2photo_files", ("edges2shoes", False)),
    ("get_edge2photo_files", ("edges2shoes", True)),
    ("get_edge2photo_files", ("edges2handbags", False)),
    ("get_facescrub_files", (False, 2)), ("get_facescrub_files", (True, 2)),
    ("get_custom_data", ("tops", "hanbok", False)),
    ("get_custom_data", ("hanbok", "tops", True)),
    ("get_celebA_files", ("Male", "Smiling", None, None, False, 1)),
    ("get_celebA_files", ("Male", "Smiling", None, None, True, 1)),
    ("get_celebA_files", ("Male", None, None, None, False, 1)),
    ("get_celebA_files", ("Male", None, "Smiling", "1", False, 1)),
    ("get_celebA_files", ("Smiling", None, "Male", "-1", True, 2)),
    ("get_celebA_files", ("Male", "Smiling", None, None, False, 0)),
], ids=lambda c: f"{c[0]}{c[1]}")
def test_resolver_matches_jax(fake_datasets, call):
    name, args = call
    got, want = getattr(res, name)(*args), getattr(jax_res, name)(*args)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert same(g, w), (g, w)


@pytest.mark.parametrize("call", [
    ("get_cars", dict(test=False, ver=180, half="first", image_size=16)),
    ("get_cars", dict(test=False, ver=180, half="last", image_size=16)),
    ("get_cars", dict(test=True, ver=180, half=None, image_size=16)),
    ("get_chairs", dict(test=False, half="first", ver=360)),
    ("get_chairs", dict(test=True, ver=180)),
    ("get_faces_3d", dict(test=False, half="last")),
    ("get_faces_3d", dict(test=True)),
], ids=lambda c: f"{c[0]}-{'-'.join(map(str, c[1].values()))}")
def test_angle_resolver_matches_jax(fake_datasets, call):
    name, kw = call
    assert same(getattr(res, name)(**kw), getattr(jax_res, name)(**kw))


TASKS = ["synthetic", "facescrub", "celebA", "edges2shoes", "edges2handbags",
         "handbags2shoes", "shoes2handbags", "tops2hanbok", "hanbok2tops",
         "car2car", "face2face", "chair2chair", "chair2car", "chair2face",
         "car2face"]


@pytest.mark.parametrize("task", TASKS)
def test_get_task_data_matches_jax(fake_datasets, task):
    args = SimpleNamespace(task_name=task, image_size=16, n_test=1,
                           style_A="Male", style_B=None, constraint=None,
                           constraint_type=None)
    got, want = res.get_task_data(args), jax_res.get_task_data(args)
    for g, w in zip(got, want, strict=True):
        assert same(g, w)
    assert res.task_domains(task) == jax_res.task_domains(task)


def test_unknown_task_is_refused(fake_datasets):
    with pytest.raises(ValueError, match="unknown task_name"):
        res.get_task_data(SimpleNamespace(task_name="nosuchtask", image_size=16))


def test_celebA_needs_no_pandas(fake_datasets, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "pandas", None)
    a, b = res.get_celebA_files("Male", "Smiling", None, None, test=False, n_test=1)
    assert len(a) == 4 and len(b) == 4


def ab_image(path, seed=0, w=512, h=256):
    rng = np.random.RandomState(seed)
    Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(path, quality=95)
    return path


@pytest.mark.parametrize("numpy_path", [False, True], ids=["cv2", "numpy"])
@pytest.mark.parametrize("domain", ["A", "B", None])
def test_decode_image_matches_jax(tmp_path, domain, numpy_path, monkeypatch):
    path = ab_image(tmp_path / "ab.jpg")
    if numpy_path:  # a host without cv2 or the native library
        from discogan_modernized_tpu.data import native as jax_native
        from discogan_modernized_torch.data import native

        monkeypatch.setattr(pp, "_cv2", lambda: None)
        monkeypatch.setattr(jax_pp, "HAVE_CV2", False)
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jax_native, "available", lambda: False)
    got, want = pp.decode_image(path, domain, 64), jax_pp.decode_image(path, domain, 64)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_decode_failures_follow_the_call_site(tmp_path):
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"junk")
    with pytest.raises(Exception):
        pp.decode_image(bad)
    assert pp.decode_image(bad, on_error="none") is None
    assert pp.decode_image(bad, image_size=8, on_error="random").shape == (8, 8, 3)
    assert pp.load_image(bad) is None


def test_read_images_matches_jax_and_skips_bad_files(tmp_path):
    good = [ab_image(tmp_path / f"{i}.jpg", seed=i) for i in range(3)]
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not an image")
    files = [str(good[0]), str(bad), str(good[1]), str(good[2])]
    got, want = pp.read_images(files, "B", 32), jax_pp.read_images(files, "B", 32)
    assert got.shape == (3, 32, 32, 3)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        pp.read_images([str(bad)], "B", 32)


def test_shuffle_data_matches_jax():
    a, b = np.arange(50), np.arange(100, 140)
    np.random.seed(3)
    want = jax_pp.shuffle_data(a, b)
    np.random.seed(3)
    got = pp.shuffle_data(a, b)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert sorted(got[0]) == list(a) and sorted(got[1]) == list(b)


# -- the native library --------------------------------------------------------

@pytest.fixture(scope="module")
def natives():
    from discogan_modernized_tpu.data import native as jax_native
    from discogan_modernized_torch.data import native

    if not (native.available() and jax_native.available()):
        pytest.fail("the native library did not build (g++ is needed)")
    return native, jax_native


def test_native_builds_into_the_repository(natives):
    native, jax_native = natives
    lib = native._build()
    assert lib.parent == Path(native.__file__).resolve().parents[2] / "build" / "native"
    assert native._SRC != jax_native._SRC
    assert native._SRC.read_text() != ""


@pytest.mark.parametrize("fn,args", [
    ("erode3x3", ((50, 60, 3),)), ("dilate3x3", ((50, 60, 3),)),
    ("resize_bilinear", ((100, 80, 3), 64)), ("resize_bilinear", ((31, 47, 3), 16)),
])
def test_native_ops_match_jax_bit_for_bit(natives, fn, args):
    native, jax_native = natives
    img = (np.random.RandomState(0).rand(*args[0]) * 255).astype(np.float32)
    got = getattr(native, fn)(img, *args[1:])
    want = getattr(jax_native, fn)(img, *args[1:])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("domain", ["A", "B", None])
@pytest.mark.parametrize("size", [16, 64, 512])
def test_native_preprocess_matches_jax_bit_for_bit(natives, domain, size):
    native, jax_native = natives
    img = (np.random.RandomState(size).rand(256, 512, 3) * 255).astype(np.uint8)
    np.testing.assert_array_equal(native.preprocess(img, domain, size),
                                  jax_native.preprocess(img, domain, size))


def test_native_is_chosen_without_cv2(natives, monkeypatch):
    native, _ = natives
    img = (np.random.RandomState(1).rand(256, 512, 3) * 255).astype(np.uint8)
    monkeypatch.setattr(pp, "_cv2", lambda: None)
    np.testing.assert_array_equal(pp.preprocess_array(img, "A", 32),
                                  native.preprocess(img, "A", 32))
    np.testing.assert_array_equal(pp.preprocess_array(img, "B", 32),
                                  native.preprocess(img, "B", 32))


# -- the decoded-sample cache --------------------------------------------------

@pytest.fixture()
def ab_files(tmp_path):
    rng = np.random.RandomState(7)
    files = []
    for i in range(12):
        p = tmp_path / f"{i}.jpg"
        Image.fromarray((rng.rand(64, 512, 3) * 255).astype(np.uint8)).save(p)
        files.append(str(p))
    return files


@pytest.fixture()
def cache_dir(tmp_path, monkeypatch):
    d = tmp_path / "cache"
    monkeypatch.setenv("DISCOGAN_TORCH_CACHE_DIR", str(d))
    return d


def count_decodes(monkeypatch):
    calls = {"n": 0, "paths": []}
    real = pl.decode_image

    def counting(path, *a, **k):
        calls["n"] += 1
        calls["paths"].append(str(path))
        return real(path, *a, **k)

    monkeypatch.setattr(pl, "decode_image", counting)
    return calls


def host_epoch(loader, epoch=0, **kw):
    return [(a.numpy().copy(), b.numpy().copy()) for a, b in loader.epoch(epoch, **kw)]


def test_cache_hits_are_bit_identical_and_skip_decode(ab_files, cache_dir, monkeypatch):
    calls = count_decodes(monkeypatch)
    loader = HostLoader(ab_files, ab_files, 4, 16, "cpu", domain_A="A", domain_B="B")
    epoch0 = host_epoch(loader)
    assert calls["n"] == 24  # 12 per domain, each decoded once
    epoch1 = host_epoch(loader)
    assert calls["n"] == 24
    for (a0, b0), (a1, b1) in zip(epoch0, epoch1, strict=True):
        np.testing.assert_array_equal(a0, a1)
        np.testing.assert_array_equal(b0, b1)
    pa, _ = epoch_perms(0, 0, 12, 12)
    want = np.stack([jax_pp.decode_image(ab_files[j], "A", 16) for j in pa[:4]])
    np.testing.assert_array_equal(epoch0[0][0], want)
    loader2 = HostLoader(ab_files, ab_files, 4, 16, "cpu", domain_A="A", domain_B="B")
    host_epoch(loader2)
    assert calls["n"] == 24  # a new loader reuses the files on disk


def test_cache_fingerprint_invalidates_on_file_change(ab_files, cache_dir, monkeypatch):
    calls = count_decodes(monkeypatch)
    host_epoch(HostLoader(ab_files[:2], ab_files[:2], 2, 16, "cpu",
                          domain_A="A", domain_B="B"))
    base = calls["n"]
    Image.fromarray((np.random.RandomState(99).rand(64, 512, 3) * 255)
                    .astype(np.uint8)).save(ab_files[0])
    now = time.time() + 10
    os.utime(ab_files[0], (now, now))
    host_epoch(HostLoader(ab_files[:2], ab_files[:2], 2, 16, "cpu",
                          domain_A="A", domain_B="B"))
    assert calls["n"] > base


def test_cache_remembers_failures(tmp_path, cache_dir, monkeypatch):
    good = ab_image(tmp_path / "good.jpg", w=512, h=64)
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"junk")
    files = [str(good), str(bad)]
    calls = count_decodes(monkeypatch)
    loader = HostLoader(files, files, 2, 16, "cpu", workers=1)
    (A0, _), = host_epoch(loader)
    assert A0.shape[0] == 1  # the bad file is skipped
    n0 = calls["n"]
    (A1, _), = host_epoch(loader)
    assert calls["n"] == n0  # and not read again
    np.testing.assert_array_equal(A0, A1)


def test_cache_opt_out(ab_files, cache_dir, monkeypatch):
    calls = count_decodes(monkeypatch)
    monkeypatch.setenv("DISCOGAN_DATA_CACHE", "0")
    loader = HostLoader(ab_files[:4], ab_files[:4], 2, 16, "cpu",
                        domain_A="A", domain_B="B")
    assert loader.caches == [None, None]
    host_epoch(loader)
    n0 = calls["n"]
    host_epoch(loader)
    assert calls["n"] == 2 * n0
    assert not list(cache_dir.glob("*.dat"))


def placeholder_paths(tmp_path, n=3):
    paths = [str(tmp_path / f"img{i}.jpg") for i in range(n)]
    for p in paths:
        Path(p).write_bytes(b"x")
    return paths


def test_cache_creation_is_race_safe(tmp_path):
    paths = placeholder_paths(tmp_path)
    c1 = DecodedCache(paths, "B", 8, root=tmp_path / "cache")
    arr = np.full((8, 8, 3), 0.5, np.float32)
    c1.store(paths[0], arr)
    c1.flush()
    c2 = DecodedCache(paths, "B", 8, root=tmp_path / "cache")
    st, got = c2.load(paths[0])
    assert st == 1
    np.testing.assert_array_equal(got, arr)
    np.testing.assert_array_equal(c1.load(paths[0])[1], arr)


def test_cache_waits_for_a_live_creator_and_steals_a_dead_ones_lock(tmp_path):
    from discogan_modernized_torch.data.cache import _fingerprint

    paths = placeholder_paths(tmp_path)
    root = tmp_path / "cache"
    root.mkdir()
    lock = root / f"{_fingerprint(paths, 'B', 8)}.lock"
    lock.write_text("999999999")  # a pid that does not run
    c = DecodedCache(paths, "B", 8, root=root)
    assert c._complete() and not lock.exists()


def test_cache_evicts_stale_generation(tmp_path):
    paths = placeholder_paths(tmp_path)
    root = tmp_path / "cache"
    c1 = DecodedCache(paths, "B", 8, root=root)
    old = c1.data_path
    del c1
    st = os.stat(paths[1])
    os.utime(paths[1], ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
    c2 = DecodedCache(paths, "B", 8, root=root)
    assert c2.data_path != old and not old.exists()
    other = DecodedCache(paths[:2], "A", 8, root=root)
    assert other.data_path.exists() and c2.data_path.exists()


def test_cache_recreation_never_truncates_existing_data(tmp_path):
    paths = placeholder_paths(tmp_path)
    c1 = DecodedCache(paths, "B", 8, root=tmp_path / "cache")
    arr = np.full((8, 8, 3), 0.25, np.float32)
    c1.store(paths[1], arr)
    c1.flush()
    data_path, status_path = c1.data_path, c1.status_path
    del c1
    status_path.unlink()
    c2 = DecodedCache(paths, "B", 8, root=tmp_path / "cache")
    assert c2.data_path == data_path and c2.load(paths[1])[0] == 0
    raw = np.memmap(data_path, dtype=np.float32, mode="r", shape=c2.shape)
    np.testing.assert_array_equal(np.asarray(raw[1]), arr)


def test_cache_data_loss_invalidates_surviving_status(tmp_path):
    paths = placeholder_paths(tmp_path)
    c1 = DecodedCache(paths, "B", 8, root=tmp_path / "cache")
    c1.store(paths[1], np.full((8, 8, 3), 0.25, np.float32))
    c1.flush()
    data_path = c1.data_path
    del c1
    data_path.unlink()
    assert DecodedCache(paths, "B", 8, root=tmp_path / "cache").load(paths[1])[0] == 0


def test_the_two_packages_never_share_a_cache(tmp_path, monkeypatch):
    from discogan_modernized_tpu.data.cache import DecodedCache as JaxCache
    from discogan_modernized_torch.data.cache import cache_root

    monkeypatch.delenv("DISCOGAN_TORCH_CACHE_DIR", raising=False)
    monkeypatch.setenv("DISCOGAN_CACHE_DIR", str(tmp_path / "jax"))
    assert cache_root() == Path(pl.__file__).resolve().parents[2] / "build" / "data_cache"
    paths = placeholder_paths(tmp_path)
    root = tmp_path / "shared"
    assert (DecodedCache(paths, "B", 8, root=root).data_path
            != JaxCache(paths, "B", 8, root=root).data_path)


# -- the host loader -------------------------------------------------------------

def test_loader_batches_are_the_files_in_epoch_order(ab_files, cache_dir):
    loader = HostLoader(ab_files, ab_files, 4, 16, "cpu", domain_A="A",
                        domain_B="B", seed=5)
    batches = host_epoch(loader, epoch=2)
    pa, pb = epoch_perms(5, 2, 12, 12)
    assert len(batches) == 3
    for i, (A, B) in enumerate(batches):
        np.testing.assert_array_equal(A, np.stack([
            jax_pp.decode_image(ab_files[j], "A", 16) for j in pa[4 * i:4 * i + 4]]))
        np.testing.assert_array_equal(B, np.stack([
            jax_pp.decode_image(ab_files[j], "B", 16) for j in pb[4 * i:4 * i + 4]]))


def test_loader_skips_bad_files(ab_files, tmp_path, cache_dir):
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"junk")
    files = ab_files[:3] + [str(bad)]
    (A, B), = host_epoch(HostLoader(files, files, 4, 16, "cpu", workers=4))
    assert A.shape == B.shape == (3, 16, 16, 3)


def test_skip_decodes_nothing_it_skips(ab_files, cache_dir, monkeypatch):
    monkeypatch.setenv("DISCOGAN_DATA_CACHE", "0")
    calls = count_decodes(monkeypatch)
    loader = HostLoader(ab_files, ab_files, 4, 16, "cpu", domain_A="A",
                        domain_B="B", seed=1)
    full = host_epoch(loader, epoch=3)
    calls["n"], calls["paths"] = 0, []
    tail = host_epoch(loader, epoch=3, skip=2)
    pa, pb = epoch_perms(1, 3, 12, 12)
    assert sorted(calls["paths"]) == sorted([ab_files[j] for j in pa[8:]]
                                            + [ab_files[j] for j in pb[8:]])
    assert len(tail) == 1
    np.testing.assert_array_equal(tail[0][0], full[2][0])
    np.testing.assert_array_equal(tail[0][1], full[2][1])


def test_domains_shuffle_independently_and_epochs_differ():
    a, b = pl.synthetic_pair(32, 8, seed=0)
    loader = HostLoader(a, b, 32, 8, "cpu", seed=0)
    (A0, B0), = host_epoch(loader, epoch=0)
    pa, pb = epoch_perms(0, 0, 32, 32)
    assert not np.array_equal(pa, pb)
    np.testing.assert_array_equal(A0, a[pa])
    np.testing.assert_array_equal(B0, b[pb])
    pa1, _ = epoch_perms(0, 1, 32, 32)
    assert not np.array_equal(pa, pa1)
    np.testing.assert_array_equal(epoch_perms(0, 1, 32, 32)[0], pa1)  # a function of (seed, epoch)
    (A1, _), = host_epoch(HostLoader(a, b, 32, 8, "cpu", seed=0), epoch=1)
    np.testing.assert_array_equal(A1, a[pa1])


def test_loader_decodes_in_parallel(ab_files, monkeypatch):
    """The decode pool has two decodes in flight at once (a barrier that
    only opens for two would time out on a serial pool)."""
    import threading

    barrier = threading.Barrier(2, timeout=30)

    def fake_decode(path, domain, image_size, on_error="none"):
        barrier.wait()
        return np.zeros((image_size, image_size, 3), np.float32)

    monkeypatch.setattr(pl, "decode_image", fake_decode)
    monkeypatch.setenv("DISCOGAN_DATA_CACHE", "0")
    loader = HostLoader(ab_files[:4], ab_files[:4], 4, 8, "cpu", workers=4)
    assert len(host_epoch(loader)) == 1
    loader.close()


def test_loader_surfaces_a_decode_crash(ab_files, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("decoder crashed")

    monkeypatch.setattr(pl, "decode_image", broken)
    monkeypatch.setenv("DISCOGAN_DATA_CACHE", "0")
    loader = HostLoader(ab_files[:4], ab_files[:4], 2, 8, "cpu")
    with pytest.raises(RuntimeError, match="decoder crashed"):
        host_epoch(loader)
