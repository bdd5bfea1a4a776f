"""The port's datasets, samplers and loader against the JAX package's.

* ``load_dataset``: equal item lists on the synthetic RGBNT201, RGBNT100
  (wide JPEG), MSVR310 and Market1501 trees that ``tests/test_data.py`` and
  ``tests/test_cli.py`` build.
* ``PKSampler`` / ``SoftmaxSampler``: equal ``epoch_indices`` and
  ``host_shard`` over seeds and epochs (the same numpy seeding formula).
* ``BatchLoader`` / ``ReIDDataModule``: equal uint8 batches through PIL
  (per-modality files and wide-JPEG tiles) and through a ``decode_fn``; the
  validation tail padded alike.
* Without PIL and without a ``decode_fn`` the first batch raises an error
  that names both; ``DATALOADER.NATIVE_DECODE`` without the codec logs one
  warning and decodes with PIL.
"""

import logging
import sys

import numpy as np
import pytest

from editor_tpu.config import load_config as jax_load_config
from editor_tpu.data import datasets as jax_datasets
from editor_tpu.data import loader as jax_loader
from editor_tpu.data import sampler as jax_sampler
from editor_tpu_torch.config import load_config
from editor_tpu_torch.data import datasets, loader, sampler
from tests.test_cli import msvr_root, tiny_root, wide_root  # noqa: F401  (fixtures)
from tests.test_data import market1501_root, rgbnt201_root  # noqa: F401  (fixtures)


@pytest.mark.parametrize("name,root", [
    ("RGBNT201", "rgbnt201_root"), ("RGBNT201", "tiny_root"), ("RGBNT100", "wide_root"),
    ("MSVR310", "msvr_root"), ("market1501", "market1501_root")])
def test_load_dataset_matches_jax(name, root, request):
    root = request.getfixturevalue(root)
    got, ref = datasets.load_dataset(name, root), jax_datasets.load_dataset(name, root)
    for split in ("train", "query", "gallery"):
        assert getattr(got, split) == getattr(ref, split) and getattr(got, split)
    for field in ("num_train_pids", "num_train_cams", "num_modalities", "wide_jpeg",
                  "has_sceneid", "num_query"):
        assert getattr(got, field) == getattr(ref, field), field
    assert (datasets.print_dataset_statistics(name, got)
            == jax_datasets.print_dataset_statistics(name, ref))
    with pytest.raises(KeyError, match="unknown dataset"):
        datasets.load_dataset("nope", root)


def _pk_items(rng):
    # uneven identities: some with fewer than K items (sampled with replacement)
    counts = rng.randint(1, 9, size=11)
    return [(None, pid, 0, -1) for pid, n in enumerate(counts) for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 3, 1111])
def test_samplers_match_jax(seed):
    rng = np.random.RandomState(seed)
    items = _pk_items(rng)
    got, ref = sampler.PKSampler(items, 8, 2, seed), jax_sampler.PKSampler(items, 8, 2, seed)
    assert got.length == ref.length
    sgot = sampler.SoftmaxSampler(len(items), 8, seed)
    sref = jax_sampler.SoftmaxSampler(len(items), 8, seed)
    for epoch in (1, 2, 7):
        for g, r in ((got, ref), (sgot, sref)):
            idx = g.epoch_indices(epoch)
            np.testing.assert_array_equal(idx, r.epoch_indices(epoch))
            assert idx.dtype == np.int64 and len(idx) % 8 == 0 and len(idx)
            for hosts in (2, 4):
                for h in range(hosts):
                    np.testing.assert_array_equal(g.host_shard(epoch, h, hosts),
                                                  r.host_shard(epoch, h, hosts))
    with pytest.raises(ValueError):
        sampler.PKSampler(items, 9, 2)


def _assert_batches_equal(got, ref):
    got, ref = list(got), list(ref)
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in g:
            assert g[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


@pytest.mark.parametrize("name,root", [("RGBNT201", "tiny_root"), ("RGBNT100", "wide_root"),
                                       ("MSVR310", "msvr_root")])
def test_data_module_batches_match_jax(name, root, request):
    """PIL decode: train batches of two epochs and the padded validation
    batches, the same arrays."""
    root = request.getfixturevalue(root)
    opts = ["DATASETS.NAMES", name, "DATASETS.ROOT_DIR", root, "INPUT.SIZE_TRAIN", "[64, 32]",
            "INPUT.SIZE_TEST", "[32, 16]", "DATALOADER.NUM_INSTANCE", "2",
            "DATALOADER.NUM_WORKERS", "2", "DATALOADER.NATIVE_DECODE", "False",
            "SOLVER.IMS_PER_BATCH", "8", "TEST.IMS_PER_BATCH", "5"]
    got = loader.ReIDDataModule(load_config(None, opts))
    ref = jax_loader.ReIDDataModule(jax_load_config(None, opts))
    for epoch in (1, 2):
        _assert_batches_equal(got.train_epoch(epoch), ref.train_epoch(epoch))
    _assert_batches_equal(got.val_batches(), ref.val_batches())
    assert got.val_pad == ref.val_pad
    assert (got.num_classes, got.cam_num, got.num_query) == (ref.num_classes, ref.cam_num,
                                                             ref.num_query)


def _decode(item):
    rng = np.random.RandomState(item[1] * 100 + item[2])
    return [rng.randint(0, 256, (16, 8, 3), dtype=np.uint8) for _ in range(3)]


def test_batch_loader_decode_fn_matches_jax():
    items = [(f"x{i}", i % 5, i % 3, i) for i in range(23)]
    idx = np.random.RandomState(0).permutation(23)
    for sceneid in (False, True):
        got = loader.BatchLoader(items, (16, 8), False, 3, has_sceneid=sceneid,
                                 num_workers=3, decode_fn=_decode)
        ref = jax_loader.BatchLoader(items, (16, 8), False, 3, has_sceneid=sceneid,
                                     num_workers=3, decode_fn=_decode)
        _assert_batches_equal(got.batches(idx, 4), ref.batches(idx, 4))


def test_decode_without_pil_or_decode_fn_raises(tiny_root, monkeypatch):  # noqa: F811
    monkeypatch.setitem(sys.modules, "PIL", None)  # `from PIL import Image` fails
    ds = datasets.load_dataset("RGBNT201", tiny_root)
    batches = loader.BatchLoader(ds.train, (64, 32), False, 3, num_workers=2).batches(
        np.arange(8), 4)
    with pytest.raises(RuntimeError, match="PIL.*decode_fn"):
        next(batches)
    # a decode_fn needs no PIL
    ok = loader.BatchLoader(ds.train, (16, 8), False, 3, decode_fn=_decode)
    assert next(ok.batches(np.arange(8), 4))["RGB"].shape == (4, 16, 8, 3)


def test_native_decode_warns_once_and_uses_pil(tiny_root, caplog, monkeypatch):  # noqa: F811
    """With the codec unavailable (its loader returns None, as where g++ or
    libjpeg is missing), NATIVE_DECODE logs one warning and PIL decodes; the
    codec's own batches are held in tests/test_torch_native.py."""
    from editor_tpu_torch import native
    monkeypatch.setattr(native, "load_imagecodec", lambda: None)
    ds = datasets.load_dataset("RGBNT201", tiny_root)
    got = loader.BatchLoader(ds.train, (64, 32), False, 3, num_workers=2, native_decode=True)
    ref = jax_loader.BatchLoader(ds.train, (64, 32), False, 3, num_workers=2)
    with caplog.at_level(logging.WARNING, logger="editor_tpu_torch.data"):
        _assert_batches_equal(got.batches(np.arange(16), 4), ref.batches(np.arange(16), 4))
    warnings = [r for r in caplog.records if r.name == "editor_tpu_torch.data"]
    assert len(warnings) == 1 and "native decode unavailable" in warnings[0].getMessage()


def test_early_stop_ends_the_producer():
    """A consumer that stops after one batch stops the prefetch thread."""
    import threading

    before = threading.active_count()
    items = [(f"x{i}", i % 5, i % 3, i) for i in range(40)]
    bl = loader.BatchLoader(items, (16, 8), False, 3, num_workers=1, prefetch=1,
                            decode_fn=_decode)
    gen = bl.batches(np.arange(40), 4)
    next(gen)
    gen.close()
    bl.pool.shutdown()
    assert threading.active_count() <= before
