"""The port's serving path reads what the JAX package's writes and honours
the config's INPUT section:

* a gallery that ``editor_tpu.serve.GalleryIndex.save`` wrote (``paths`` as
  an object array) loads in the port and gives the same search results;
* a ``FeatureExtractor`` given an INPUT section with a non-default
  ``PIXEL_MEAN``/``PIXEL_STD`` gives the JAX ``FeatureExtractor``'s features
  for the same weights and images, and its ``size_hw`` is ``SIZE_TEST``.

The extractors run the tiny EDITOR at float64 on both sides on images
normalised in float32. The JAX extractor normalises inside its jit, where
XLA may turn the division by a std such as 0.229 into a product with its
reciprocal: an input may differ by one float32 ulp, so the features are held
to float32 tolerances (rtol 1e-5, atol 1e-6), while the default 0.5/0.5
normalisation moves them by more than 1e-3.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editor_tpu.config import InputConfig as JaxInputConfig
from editor_tpu.models.editor import EditorConfig as JaxEditorConfig
from editor_tpu.models.vit import ViTConfig as JaxViTConfig
from editor_tpu.serve import FeatureExtractor as JaxFeatureExtractor
from editor_tpu.serve import GalleryIndex as JaxGalleryIndex
from editor_tpu_torch.config import InputConfig
from editor_tpu_torch.serve import FeatureExtractor, GalleryIndex
from tests.torch_parity import assert_close, jax_editor, port_editor, x64  # noqa: F401

MODS = ("RGB", "NI", "TI")
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)  # ImageNet's, not 0.5
SIZE = (64, 32)


def _requests(n, seed):
    rng = np.random.RandomState(seed)
    imgs = {m: rng.randint(0, 256, (n, *SIZE, 3), dtype=np.uint8) for m in MODS}
    return imgs, (np.arange(n) % 4).astype(np.int32)


@pytest.fixture(scope="module")
def tiny(x64):
    vit = JaxViTConfig(img_size=SIZE, patch_size=16, stride_size=(16, 16), embed_dim=96,
                       depth=2, num_heads=4, mlp_ratio=2.0, camera=4)
    jcfg = JaxEditorConfig(num_classes=10, vit=vit, head_keep=2, frequency_keep=3,
                           use_pallas=False)
    params, state = jax_editor(jcfg)
    return jcfg, params, state


def test_extractor_honours_input_section(tiny):
    jcfg, params, state = tiny
    jinput = dataclasses.replace(JaxInputConfig(), SIZE_TEST=SIZE, PIXEL_MEAN=MEAN,
                                 PIXEL_STD=STD)
    ref_ex = JaxFeatureExtractor(
        types.SimpleNamespace(INPUT=jinput), jcfg,
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, state), batch_size=4,
        compute_dtype=jnp.float64)
    model = port_editor(jcfg, params, state)
    got_ex = FeatureExtractor(model, batch_size=4, compute_dtype=torch.float64,
                              input_cfg=InputConfig(SIZE_TEST=SIZE, PIXEL_MEAN=MEAN,
                                                    PIXEL_STD=STD))
    assert got_ex.size_hw == SIZE == ref_ex.size_hw
    imgs, cams = _requests(3, seed=5)
    got = got_ex(imgs, cams)
    assert_close(got, ref_ex(imgs, cams), rtol=1e-5, atol=1e-6)
    # the section is what moved the features: the defaults give others
    plain = FeatureExtractor(model, batch_size=4, compute_dtype=torch.float64)
    assert plain.size_hw == SIZE
    assert np.abs(plain(imgs, cams) - got).max() > 1e-3


def test_gallery_saved_by_jax_loads_in_port(tmp_path):
    rng = np.random.RandomState(3)
    feats = rng.randn(9, 24).astype(np.float32)
    pids, cams = list(range(9)), (np.arange(9) % 3).tolist()
    paths = [f"gallery/{i:04d}.jpg" for i in range(9)]
    ref = JaxGalleryIndex(24)
    ref.add(feats[:4], pids[:4], cams[:4], paths[:4])
    ref.add(feats[4:], pids[4:], cams[4:], paths[4:])
    path = str(tmp_path / "jax_gallery.npz")
    ref.save(path)
    with np.load(path, allow_pickle=True) as z:
        assert z["paths"].dtype == object  # the layout the port could not read
    got = GalleryIndex.load(path)
    assert len(got) == 9 and got.feat_norm and got._paths == paths
    queries = feats[[8, 1, 4]] + 1e-3 * rng.randn(3, 24).astype(np.float32)
    res = got.search(queries, topk=5)
    assert res == ref.search(queries, topk=5)
    assert [r[0]["pid"] for r in res] == [8, 1, 4]
    assert [r[0]["path"] for r in res] == [paths[8], paths[1], paths[4]]
