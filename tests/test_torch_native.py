"""The port's native C++ code and device re-ranking against the JAX package's.

* Re-ranking: the port's C++ ``k_reciprocal_rerank_native`` equals JAX's
  C++ one (the same source on the same float32 inputs: bit for bit) and its
  numpy one within atol 1e-5 (``tests/test_native.py``'s tolerance: the C++
  sums in another order). ``rerank_auto`` without the library runs the
  port's numpy copy. A failed build is logged once with the compiler's
  message and counts as unavailable.
* The device re-ranking (``evals/reranking_device``) on CPU tensors matches
  ``k_reciprocal_rerank_jax`` and the numpy copy within atol 1e-5, on
  clustered features without tied distances (``torch.topk`` and
  ``jax.lax.top_k`` may order ties differently, which moves the masks).
* ``R1mAPEvaluator(reranking=True)`` and ``GalleryIndex.search(
  reranking=True)`` route through ``rerank_auto`` and give JAX's results
  (both packages on their C++ code): the evaluator's CMC equal, mAP within
  1e-6 and distances within 1e-5 (torch and XLA normalise the features to
  float32 ulps apart), the gallery's matches equal.
* The JPEG codec: ``decode_resize_batch`` and ``decode_resize_multicrop``
  equal JAX's byte for byte on JPEGs made from a seed, including the
  wide-JPEG crops; a failed decode raises. ``ReIDDataModule`` with
  ``DATALOADER.NATIVE_DECODE`` gives JAX's batches on the per-modality and
  the wide-JPEG trees, and a batch whose decode fails goes through PIL.
"""

import logging

import numpy as np
import pytest
import torch
from PIL import Image

import editor_tpu.native as jax_native
from editor_tpu.config import load_config as jax_load_config
from editor_tpu.data import loader as jax_loader
from editor_tpu.evals import metrics as jax_metrics
from editor_tpu.evals.reranking import k_reciprocal_rerank as jax_rerank_numpy
from editor_tpu.evals.reranking_jax import k_reciprocal_rerank_jax
from editor_tpu.serve import GalleryIndex as JaxGalleryIndex
from editor_tpu_torch import native
from editor_tpu_torch.config import load_config
from editor_tpu_torch.data import loader
from editor_tpu_torch.evals import metrics
from editor_tpu_torch.evals.reranking import k_reciprocal_rerank
from editor_tpu_torch.evals.reranking_device import k_reciprocal_rerank_device
from editor_tpu_torch.serve import GalleryIndex
from tests.test_cli import tiny_root, wide_root  # noqa: F401  (fixtures)
from tests.torch_parity import jax_native_private  # noqa: F401  (fixture)

RERANK_ATOL = 1e-5


def _clustered(seed, nq=30, ng=120, dim=16, n_centers=10):
    """Features around well-separated centres (tests/test_native.py's)."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_centers, dim) * 5
    q = (centers[rng.randint(0, n_centers, nq)] + 0.5 * rng.randn(nq, dim)).astype(np.float32)
    g = (centers[rng.randint(0, n_centers, ng)] + 0.5 * rng.randn(ng, dim)).astype(np.float32)
    return q, g


@pytest.fixture(scope="module")
def libs(jax_native_private):
    if jax_native.load_native() is None or native.load_native() is None:
        pytest.fail("the native re-ranking library does not build here (g++ with OpenMP)")


@pytest.mark.parametrize("k1,k2,seed", [(10, 4, 0), (20, 6, 1), (50, 15, 2)])
def test_native_rerank_matches_jax(libs, k1, k2, seed):
    q, g = _clustered(seed)
    got = native.k_reciprocal_rerank_native(q, g, k1=k1, k2=k2, lambda_value=0.3)
    assert got.shape == (30, 120) and got.dtype == np.float32
    assert np.array_equal(got, jax_native.k_reciprocal_rerank_native(q, g, k1, k2, 0.3))
    np.testing.assert_allclose(got, jax_rerank_numpy(q, g, k1=k1, k2=k2, lambda_value=0.3),
                               rtol=0, atol=RERANK_ATOL)
    np.testing.assert_allclose(got, k_reciprocal_rerank(q, g, k1=k1, k2=k2, lambda_value=0.3),
                               rtol=0, atol=RERANK_ATOL)
    assert np.array_equal(native.rerank_auto(q, g, k1, k2, 0.3), got)


def test_rerank_auto_falls_back_to_numpy(monkeypatch):
    monkeypatch.setattr(native, "load_native", lambda: None)
    rng = np.random.RandomState(1)
    q, g = rng.randn(8, 8).astype(np.float32), rng.randn(30, 8).astype(np.float32)
    with pytest.raises(RuntimeError, match="unavailable"):
        native.k_reciprocal_rerank_native(q, g)
    got = native.rerank_auto(q, g, k1=5, k2=2, lambda_value=0.3)
    assert np.array_equal(got, k_reciprocal_rerank(q, g, k1=5, k2=2, lambda_value=0.3))


def test_failed_build_is_logged_once(tmp_path, monkeypatch, caplog):
    """A source the compiler refuses: one warning with the compiler's
    message, the library unavailable, no second build or warning."""
    (tmp_path / "reranking.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "HERE", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_LIBS", {})
    with caplog.at_level(logging.WARNING, logger="editor_tpu_torch.native"):
        assert native.load_native() is None
        assert native.load_native() is None
    msgs = [r.getMessage() for r in caplog.records if r.name == "editor_tpu_torch.native"]
    assert len(msgs) == 1 and "reranking unavailable" in msgs[0] and "error" in msgs[0], msgs
    assert not list((tmp_path / "_build").glob("*.so")) and not list(
        (tmp_path / "_build").glob("*.tmp"))
    with pytest.raises(RuntimeError, match="unavailable"):
        native.k_reciprocal_rerank_native(np.zeros((2, 4), np.float32),
                                          np.zeros((3, 4), np.float32))


@pytest.mark.parametrize("k1,k2,seed,nq,ng", [(10, 4, 0, 30, 120), (20, 6, 3, 130, 70)])
def test_device_rerank_matches_jax(k1, k2, seed, nq, ng):
    """130 queries: two query tiles of 128, the second short."""
    q, g = _clustered(seed, nq=nq, ng=ng)
    got = k_reciprocal_rerank_device(torch.from_numpy(q), torch.from_numpy(g), k1=k1, k2=k2,
                                     lambda_value=0.3)
    assert got.shape == (nq, ng) and got.dtype == np.float32
    np.testing.assert_allclose(got, k_reciprocal_rerank_jax(q, g, k1, k2, 0.3),
                               rtol=0, atol=RERANK_ATOL)
    np.testing.assert_allclose(got, k_reciprocal_rerank(q, g, k1=k1, k2=k2, lambda_value=0.3),
                               rtol=0, atol=RERANK_ATOL)
    # numpy features on a device named by the caller
    assert np.array_equal(k_reciprocal_rerank_device(q, g, k1, k2, 0.3, device="cpu"), got)


def test_evaluator_and_gallery_rerank_through_native(libs):
    q, g = _clustered(4, nq=10, ng=60)
    pids = np.concatenate([np.arange(10) % 5, np.arange(60) % 5]).astype(np.int32)
    cams = np.concatenate([np.zeros(10), np.ones(60)]).astype(np.int32)
    feats = np.concatenate([q, g])
    out = []
    for cls, f in ((jax_metrics.R1mAPEvaluator, feats),
                   (metrics.R1mAPEvaluator, torch.from_numpy(feats))):
        ev = cls(10, reranking=True)
        ev.update(f, pids, cams)
        out.append(ev.compute())
    ref, got = out
    np.testing.assert_array_equal(got[0], np.asarray(ref[0]))
    assert abs(got[1] - float(ref[1])) <= 1e-6
    # the same C++ code; the features were normalised by torch and by XLA
    # (float32 ulps apart)
    np.testing.assert_allclose(got[2], np.asarray(ref[2]), rtol=0, atol=RERANK_ATOL)
    # both indexes normalise with the same numpy code: the same distances
    got_idx, ref_idx = GalleryIndex(16), JaxGalleryIndex(16)
    for idx in (got_idx, ref_idx):
        idx.add(g, list(range(60)), [1] * 60, [f"g{i}" for i in range(60)])
    assert got_idx.search(q, topk=5, reranking=True) == ref_idx.search(q, topk=5,
                                                                       reranking=True)


@pytest.fixture(scope="module")
def codec(jax_native_private):
    if jax_native.load_imagecodec() is None or native.load_imagecodec() is None:
        pytest.fail("the JPEG codec does not build here (g++ and libjpeg headers)")


def _jpegs(tmp_path, n, shape, seed):
    rng = np.random.RandomState(seed)
    paths = []
    for i in range(n):
        p = str(tmp_path / f"{seed}_{i}.jpg")
        Image.fromarray(rng.randint(0, 255, shape, np.uint8)).save(p, quality=95)
        paths.append(p)
    return paths


def test_decode_matches_jax_byte_for_byte(codec, tmp_path):
    paths = [p for i in range(3) for p in _jpegs(tmp_path, 2, (96 + 8 * i, 48, 3), seed=i)]
    got = native.decode_resize_batch(paths, (64, 32))
    assert got.shape == (6, 64, 32, 3) and got.dtype == np.uint8
    assert np.array_equal(got, jax_native.decode_resize_batch(paths, (64, 32)))
    # the wide-JPEG tiles, cropped per item and decoded once per image
    wide = _jpegs(tmp_path, 2, (128, 768, 3), seed=7)
    crops = dict(crop_w=256, crop_h=128)
    got = native.decode_resize_batch(wide * 3, (64, 32), crop_x0=[0, 0, 256, 256, 512, 512],
                                     **crops)
    assert np.array_equal(got, jax_native.decode_resize_batch(
        wide * 3, (64, 32), crop_x0=[0, 0, 256, 256, 512, 512], **crops))
    multi = native.decode_resize_multicrop(wide, (64, 32), [[0, 256, 512]] * 2, **crops)
    assert np.array_equal(multi, jax_native.decode_resize_multicrop(
        wide, (64, 32), [[0, 256, 512]] * 2, **crops))
    assert np.array_equal(multi[[0, 3, 1, 4, 2, 5]], got)


def test_decode_failures_are_reported(codec, tmp_path):
    good = _jpegs(tmp_path, 1, (64, 32, 3), seed=0)
    with pytest.raises(RuntimeError, match="1/2 decodes failed"):
        native.decode_resize_batch(good + [str(tmp_path / "missing.jpg")], (64, 32))
    with pytest.raises(RuntimeError, match="decodes failed"):
        native.decode_resize_multicrop([str(tmp_path / "nope.jpg")], (64, 32), [[0]],
                                       crop_w=256, crop_h=128)


def _data_modules(root, name, extra=()):
    opts = ["DATASETS.NAMES", name, "DATASETS.ROOT_DIR", root, "INPUT.SIZE_TRAIN", "[64, 32]",
            "INPUT.SIZE_TEST", "[64, 32]", "DATALOADER.NUM_INSTANCE", "2",
            "SOLVER.IMS_PER_BATCH", "8", "TEST.IMS_PER_BATCH", "4",
            "DATALOADER.NUM_WORKERS", "2", "DATALOADER.NATIVE_DECODE", "True", *extra]
    return (loader.ReIDDataModule(load_config(None, opts)),
            jax_loader.ReIDDataModule(jax_load_config(None, opts)))


def _assert_batches_equal(got, ref):
    got, ref = list(got), list(ref)
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("name,root", [("RGBNT201", "tiny_root"), ("RGBNT100", "wide_root")])
def test_data_module_native_decode_matches_jax(codec, name, root, request, monkeypatch):
    calls = []
    for fn in ("decode_resize_batch", "decode_resize_multicrop"):
        inner = getattr(native, fn)
        monkeypatch.setattr(native, fn, lambda *a, _f=inner, _n=fn, **k: calls.append(_n)
                            or _f(*a, **k))
    dm, ref = _data_modules(request.getfixturevalue(root), name)
    assert dm.train_loader.native_decode and ref.train_loader.native_decode
    _assert_batches_equal(dm.train_epoch(1), ref.train_epoch(1))
    _assert_batches_equal(dm.val_batches(), ref.val_batches())
    assert dm.train_loader.native_decode and dm.val_loader.native_decode  # the codec stayed on
    # one codec call a batch, the wide JPEGs decoded once for their tiles
    n_batches = len(dm.sampler.epoch_indices(1)) // 8 + -(-len(dm.val_items) // 4)
    wide = name == "RGBNT100"
    assert calls == ["decode_resize_multicrop" if wide else "decode_resize_batch"] * n_batches


def test_failed_native_batch_falls_back_to_pil(codec, tiny_root, tmp_path,  # noqa: F811
                                               caplog):
    """A file the codec cannot decode (a PNG under a .jpg name): that batch
    goes through PIL with a warning, and three failing batches in a row
    turn the codec off."""
    from editor_tpu_torch.data import datasets
    items = list(datasets.load_dataset("RGBNT201", tiny_root).train[:4])
    png = str(tmp_path / "odd.jpg")
    Image.open(items[0][0][0]).save(png, format="PNG")
    items[0] = ((png,) + tuple(items[0][0][1:]),) + tuple(items[0][1:])
    got = loader.BatchLoader(items, (64, 32), False, 3, num_workers=2, native_decode=True)
    ref = loader.BatchLoader(items, (64, 32), False, 3, num_workers=2)
    with caplog.at_level(logging.WARNING, logger="editor_tpu_torch.data"):
        for _ in range(3):
            assert got.native_decode
            a, b = got._assemble(np.arange(4)), ref._assemble(np.arange(4))
            assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not got.native_decode
    msgs = [r.getMessage() for r in caplog.records if r.name == "editor_tpu_torch.data"]
    assert len(msgs) == 3 and all("PIL fallback for this batch" in m for m in msgs)
    assert "disabling native decode" in msgs[-1] and "disabling" not in msgs[1]
