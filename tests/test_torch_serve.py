"""The port's serving path against the JAX package's: FeatureExtractor
(pad-and-trim request batching over the eval step) and GalleryIndex.

The port's extractor runs the tiny EDITOR at float64 on uint8 requests; the
oracle is the JAX ``build_eval_step`` at float64 on the same weights and the
same normalised images, unpadded. Both return float32 roundings of float64
features, so they agree to one float32 ulp (rtol 2**-23). The gallery's
distances are numpy on both sides and agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editor_tpu.engine.evaluate import build_eval_step
from editor_tpu.models.editor import EditorConfig as JaxEditorConfig
from editor_tpu.models.vit import ViTConfig as JaxViTConfig
from editor_tpu.serve import GalleryIndex as JaxGalleryIndex
from editor_tpu_torch.serve import FeatureExtractor, GalleryIndex
from tests.torch_parity import assert_close, jax_editor, port_editor, x64  # noqa: F401

MODS = ("RGB", "NI", "TI")


@pytest.fixture(scope="module")
def extractors(x64):
    vit = JaxViTConfig(img_size=(64, 32), patch_size=16, stride_size=(16, 16),
                       embed_dim=96, depth=2, num_heads=4, mlp_ratio=2.0, camera=4)
    jcfg = JaxEditorConfig(num_classes=10, vit=vit, head_keep=2, frequency_keep=3,
                           use_pallas=False)
    params, state = jax_editor(jcfg)
    step = build_eval_step(jcfg, jnp.float64)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jax.tree_util.tree_map(jnp.asarray, state)

    def ref(imgs, cams):
        # the eval transform in numpy float32: x / 255, then (x - 0.5) / 0.5
        batch = {m: jnp.asarray((v.astype(np.float32) / np.float32(255.0)
                                 - np.float32(0.5)) / np.float32(0.5))
                 for m, v in imgs.items()}
        batch["camid"] = jnp.asarray(cams)
        return np.asarray(step(jparams, jstate, batch))

    got = FeatureExtractor(port_editor(jcfg, params, state), batch_size=4,
                           compute_dtype=torch.float64)
    return got, ref


def _requests(n, seed):
    rng = np.random.RandomState(seed)
    imgs = {m: rng.randint(0, 256, (n, 64, 32, 3), dtype=np.uint8) for m in MODS}
    return imgs, (np.arange(n) % 4).astype(np.int32)


@pytest.mark.parametrize("n", [1, 3, 5])
def test_extractor_matches_jax(extractors, n):
    """Request sizes 1 and 3 pad to the 1- and 4-buckets; 5 runs one full
    chunk of 4 and a 1-bucket tail."""
    got_ex, ref_ex = extractors
    imgs, cams = _requests(n, seed=n)
    got = got_ex(imgs, cams)
    assert got.shape == (n, got_ex.feat_dim) and got.dtype == np.float32
    assert_close(got, ref_ex(imgs, cams), rtol=2.0 ** -23, atol=1e-12)


def test_extractor_empty_request(extractors):
    got_ex, _ = extractors
    imgs, _ = _requests(0, seed=0)
    assert got_ex(imgs).shape == (0, got_ex.feat_dim)
    with pytest.raises(ValueError):
        got_ex({})


def test_gallery_search_matches_jax(extractors, tmp_path, monkeypatch):
    got_ex, _ = extractors
    imgs, cams = _requests(8, seed=11)
    feats = got_ex(imgs, cams)
    pids, paths = list(range(8)), [f"g{i}.jpg" for i in range(8)]
    got_idx, ref_idx = GalleryIndex(got_ex.feat_dim), JaxGalleryIndex(got_ex.feat_dim)
    for idx in (got_idx, ref_idx):
        idx.add(feats[:5], pids[:5], cams[:5].tolist(), paths[:5])
        idx.add(feats[5:], pids[5:], cams[5:].tolist(), paths[5:])
    queries = feats[[2, 7, 0]] + 1e-3 * np.random.RandomState(1).randn(3, feats.shape[1])
    got = got_idx.search(queries, topk=4)
    assert got == ref_idx.search(queries, topk=4)
    assert [m[0]["pid"] for m in got] == [2, 7, 0]
    # .npz persistence, readable by both packages
    path = str(tmp_path / "gallery.npz")
    got_idx.save(path)
    for cls in (GalleryIndex, JaxGalleryIndex):
        back = cls.load(path)
        assert len(back) == 8 and back.search(queries, topk=4) == got
    # k-reciprocal re-ranking: both packages' calls pinned to their numpy
    # implementations (rerank_auto may take the native C++ one); the same
    # float32 numpy algorithm on the same features gives the same distances
    # and ranking
    import editor_tpu.native
    import editor_tpu_torch.native
    from editor_tpu.evals.reranking import k_reciprocal_rerank
    from editor_tpu_torch.evals.reranking import k_reciprocal_rerank as port_rerank
    monkeypatch.setattr(editor_tpu.native, "rerank_auto", k_reciprocal_rerank)
    monkeypatch.setattr(editor_tpu_torch.native, "rerank_auto", port_rerank)
    reranked = got_idx.search(queries, topk=4, reranking=True)
    assert reranked == ref_idx.search(queries, topk=4, reranking=True)
    assert [m[0]["pid"] for m in reranked] == [2, 7, 0]
    with pytest.raises(ValueError):
        got_idx.add(feats[:, :-1], pids)
