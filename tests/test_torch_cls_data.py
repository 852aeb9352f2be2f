"""The port's classification data path and the loaders' worker pools on the
CPU: ``ClassificationDataset`` and ``ClassificationLoader`` against the JAX
package's, the port's ``DecodePool`` (the cases of tests/test_decode_pool.py),
and serial = thread = process epochs for both loaders.

Tolerances: class lists, sample lists, labels, ``num_real`` and epoch
order equal; images within +-1 per pixel of the JAX package's (the port
resizes with torch's bilinear interpolation, the JAX package with cv2's
fixed-point one). Pooled epochs are BYTE-equal to the serial one: every
sample's draws are seeded by (seed, epoch, position).

A worker process that hangs would hang the run, so each pooled epoch is read
on a thread with a time limit, and the pool is stopped if it runs over.
"""
import threading

import numpy as np
import pytest
import torch

import fastvision_tpu.data as jd
from fastvision_tpu_torch.data import (
    Augmentation,
    ClassificationDataset,
    ClassificationLoader,
    DecodePool,
    DetectionLoader,
    HorizontalFlip,
    HSVJitter,
    parse_worker_backend,
)
from fastvision_tpu_torch.testing import SyntheticDetectionDataset, write_classification_dataset

torch.set_num_threads(2)
SIZES = ((40, 50), (32, 32), (60, 30), (45, 45))
EPOCH_TIMEOUT_S = 60


@pytest.fixture(scope="module")
def cls_root(tmp_path_factory):
    return write_classification_dataset(str(tmp_path_factory.mktemp("cls")), 23, num_classes=4,
                                        sizes=SIZES, seed=3)


def _collect(loader, epoch=0, start_batch=0):
    """The epoch's batches, read on a thread that must finish in time."""
    out, errors = [], []

    def read():
        try:
            out.extend({k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in b.items()}
                       for b in loader.epoch(epoch, start_batch=start_batch))
        except BaseException as e:  # re-raised below
            errors.append(e)

    t = threading.Thread(target=read, daemon=True)
    t.start()
    t.join(EPOCH_TIMEOUT_S)
    if t.is_alive():
        loader.close()
        pytest.fail(f"a pooled epoch did not finish in {EPOCH_TIMEOUT_S} s")
    if errors:
        raise errors[0]
    return out


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], np.ndarray):
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
            elif k == "meta":
                assert [m["id"] for m in x[k]] == [m["id"] for m in y[k]]
            else:
                assert x[k] == y[k], k


# ---------------------------------------------------------------- DecodePool
def _double(item):
    i = int(item)
    return np.full((4, 4, 3), i % 251, np.uint8), i * 2


def _sometimes_fail(item):
    if int(item) == 3:
        raise ValueError("boom on 3")
    return np.zeros((4, 4, 3), np.uint8), int(item)


def test_pool_ordered_serial_errors_and_abandoned_reuse():
    pool = DecodePool(_double, num_workers=2, slot_shape=(4, 4, 3))
    try:
        assert [aux for _, aux in pool.imap(range(37))] == [i * 2 for i in range(37)]
        for i, (view, _) in enumerate(pool.imap(range(5))):
            assert view.shape == (4, 4, 3) and int(view[0, 0, 0]) == i % 251
        it = pool.imap(range(30))
        next(it), next(it)
        del it  # abandoned mid-flight: the ring must not be corrupted
        assert [aux for _, aux in pool.imap(range(6))] == [i * 2 for i in range(6)]
    finally:
        pool.close()
    assert [aux for _, aux in DecodePool(_double, 0, (4, 4, 3)).imap(range(5))] == [0, 2, 4, 6, 8]
    pool = DecodePool(_sometimes_fail, num_workers=2, slot_shape=(4, 4, 3))
    try:
        with pytest.raises(RuntimeError, match="boom on 3"):
            list(pool.imap(range(8)))
        assert [aux for _, aux in pool.imap([0, 1, 2])] == [0, 1, 2]  # the pool survives
    finally:
        pool.close()
    assert not any(p.is_alive() for p in pool._procs)


def test_worker_backend_spellings():
    assert parse_worker_backend("process") == ("process", "fork")
    assert parse_worker_backend("process:spawn") == ("process", "spawn")
    assert parse_worker_backend("thread") == ("thread", "fork")
    for bad in ("process:greenlet", "thread:fork", "procss"):
        with pytest.raises(ValueError):
            parse_worker_backend(bad)
        with pytest.raises(ValueError):
            ClassificationLoader([], worker_backend=bad)


# ---------------------------------------------------------------- classification vs JAX
def test_classification_dataset_matches_jax(cls_root):
    port, jax_ds = ClassificationDataset(cls_root, "val"), jd.ClassificationDataset(cls_root, "val")
    assert port.class_names == jax_ds.class_names == [f"class_{c:03d}" for c in range(4)]
    assert port.samples == jax_ds.samples
    img, lab = port[5]
    jimg, jlab = jax_ds[5]
    np.testing.assert_array_equal(img, jimg)  # cv2 and the numpy BMP reader agree
    assert lab == jlab
    cats = ["class_003", "class_001"]
    assert ClassificationDataset(cls_root, "val", cats).samples == \
        jd.ClassificationDataset(cls_root, "val", cats).samples


@pytest.mark.parametrize("train", [True, False])
def test_classification_loader_matches_jax(cls_root, train):
    kw = dict(input_size=32, batch_size=5, train=train, seed=4)
    port = ClassificationLoader(ClassificationDataset(cls_root, "train"),
                                augmentation=Augmentation([HorizontalFlip(p=0.5)]), **kw)
    jax_loader = jd.ClassificationLoader(jd.ClassificationDataset(cls_root, "train"),
                                         augmentation=jd.Augmentation([jd.HorizontalFlip(p=0.5)]),
                                         **kw)
    assert len(port) == len(jax_loader) == (4 if train else 5)
    for epoch in (0, 1):
        got, want = _collect(port, epoch), list(jax_loader.epoch(epoch))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g["num_real"] == w["num_real"]
            np.testing.assert_array_equal(g["labels"], w["labels"])
            assert g["images"].dtype == np.uint8 and g["images"].shape == w["images"].shape
            diff = np.abs(g["images"].astype(int) - w["images"].astype(int))
            assert diff.max() <= 1
    if not train:
        assert got[-1]["num_real"] == 3  # 23 = 4 x 5 + 3: padded with the last image
        np.testing.assert_array_equal(got[-1]["images"][3], got[-1]["images"][2])
        assert got[-1]["labels"][4] == got[-1]["labels"][2]


# ---------------------------------------------------------------- serial = thread = process
def _multithreaded_torch_op():
    """Run the intra-op thread pool in this (the parent) process, so a
    worker forked after it inherits a used pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        x = torch.rand(1, 3, 512, 512)
        torch.nn.functional.interpolate(x, size=(300, 300), mode="bilinear")
        (torch.rand(256, 256) @ torch.rand(256, 256)).sum()
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("train", [True, False])
def test_classification_backends_byte_equal(cls_root, train):
    ds = ClassificationDataset(cls_root, "train")
    kw = dict(input_size=32, batch_size=5, train=train, seed=2,
              augmentation=Augmentation([HorizontalFlip(p=0.5)]))
    serial = [_collect(ClassificationLoader(ds, **kw), e) for e in (0, 1)]
    _multithreaded_torch_op()
    for backend in ("thread", "process"):
        loader = ClassificationLoader(ds, num_workers=3, worker_backend=backend, **kw)
        try:
            for e in (0, 1):  # the pool is reused across epochs
                _assert_same(_collect(loader, e), serial[e])
            _assert_same(_collect(loader, 1, start_batch=2), serial[1][2:])
        finally:
            loader.close()
    if train:  # another epoch, another shuffle and other flips
        assert any(not np.array_equal(a["images"], b["images"])
                   for a, b in zip(serial[0], serial[1]))


def test_fork_after_multithreaded_torch_op():
    """Workers forked from a parent whose intra-op pool has run must not
    hang in their first parallel region: a 480 x 640 -> 224 resize is large
    enough to enter one (without ``torch.set_num_threads(1)`` in the worker
    this epoch never ends)."""
    rng = np.random.default_rng(0)
    ds = [(rng.integers(0, 256, (480, 640, 3), np.uint8), i % 3) for i in range(6)]
    kw = dict(input_size=224, batch_size=3, train=False)
    serial = _collect(ClassificationLoader(ds, **kw))
    _multithreaded_torch_op()
    loader = ClassificationLoader(ds, num_workers=2, worker_backend="process", **kw)
    try:
        _assert_same(_collect(loader), serial)
    finally:
        loader.close()


def _det_loader(**kw):
    return DetectionLoader(SyntheticDetectionDataset(11, 3, seed=5, sizes=SIZES), input_size=64,
                           batch_size=4, max_boxes=6, seed=3, **kw)


@pytest.mark.parametrize("train", [True, False])
def test_detection_backends_byte_equal(train):
    """Mosaic, flips and HSV on the train path, the ragged last eval batch;
    ``epoch(start_batch=)`` (resume) on every backend."""
    kw = dict(train=train)
    if train:
        kw.update(augmentation=Augmentation([HorizontalFlip(p=0.5), HSVJitter(p=0.5)]),
                  mosaic_prob=0.5)
    serial = [_collect(_det_loader(**kw), e) for e in (0, 1)]
    _multithreaded_torch_op()
    for backend in ("thread", "process"):
        loader = _det_loader(num_workers=3, worker_backend=backend, **kw)
        try:
            for e in (0, 1):
                _assert_same(_collect(loader, e), serial[e])
            _assert_same(_collect(loader, 0, start_batch=1), serial[0][1:])
        finally:
            loader.close()
    if not train:
        assert serial[0][-1]["num_real"] == 3 and len(serial[0][-1]["meta"]) == 3


def test_process_pool_follows_input_size_and_forkserver():
    """Multi-scale training changes input_size between epochs: the forked
    pool (whose workers hold the old size) is rebuilt. 'process:forkserver'
    pickles the loader into fresh workers and gives the same batches."""
    serial = _collect(_det_loader(train=True), 1)
    loader = _det_loader(train=True, num_workers=2, worker_backend="process")
    try:
        small = _collect(loader, 0)
        assert small[0]["images"].shape[1:] == (64, 64, 3)
        pool = loader._decode_pool
        loader.input_size = 96
        big = _collect(loader, 1)
        assert big[0]["images"].shape[1:] == (96, 96, 3) and loader._decode_pool is not pool
        loader.input_size = 64
        _assert_same(_collect(loader, 1), serial)
    finally:
        loader.close()
    fs = _det_loader(train=True, num_workers=2, worker_backend="process:forkserver")
    try:
        _assert_same(_collect(fs, 1), serial)
    finally:
        fs.close()
