"""The port's HTTP RetrievalServer and ``cli.serve.build_service`` against
the JAX package's, on the CPU at float64 (JAX x64 on).

Both servers run the tiny EDITOR (depth 2, width 96) with the same weights
(``state_dict_from_jax``) on port 0 and answer the same PNG requests (PNG is
lossless: both decode the same pixels). Compared: ``/healthz`` equal;
``/query`` matches with equal pids, camids and paths and distances within
1e-6; the 2-modal fill (NI from RGB, TI from NI); ``/gallery/add``; the 400
and 404 bodies. 8 concurrent queries to the port's server equal 8 serial
ones. ``build_service`` indexes a seeded RGBNT201-layout tree to JAX's
gallery (equal pids, camids and paths; features within 1e-6 of JAX's
``build_service``, whose jit normalises at float64 under x64, and within one
float32 ulp of JAX's eval step on float32-normalised images), from a
JAX-exported ``.pth`` both load; a saved index reloads with equal search
results.

Tolerances: both extractors compute at float64 and return float32
features, JAX's after normalising the uint8 images inside its jit (at
float64 under x64), the port's after normalising them in float32: the
features differ by a float32 ulp or two (4.8e-7 seen). The gallery's
distances are float32 |q|^2 + |g|^2 - 2 q.g of unit vectors, which such a
difference moves by a few float32 ulps of 2 (2.4e-7 seen): DIST_ATOL =
1e-6.
"""

import base64
import io
import json
import os
import os.path as osp
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from editor_tpu.config import Config as JaxConfig
from editor_tpu.models.editor import EditorConfig as JaxEditorConfig
from editor_tpu.models.vit import ViTConfig as JaxViTConfig
from editor_tpu.serve import FeatureExtractor as JaxFeatureExtractor
from editor_tpu.serve import GalleryIndex as JaxGalleryIndex
from editor_tpu.serve import RetrievalServer as JaxRetrievalServer
from editor_tpu_torch.config import Config
from editor_tpu_torch.serve import FeatureExtractor, GalleryIndex, RetrievalServer
from tests.torch_parity import (jax_native_private, port_editor,  # noqa: F401
                                torch_editor_config, x64)

MODS = ("RGB", "NI", "TI")
DIST_ATOL = 1e-6


def _imgs(n, seed):
    rng = np.random.RandomState(seed)
    return {m: rng.randint(0, 256, (n, 64, 32, 3), dtype=np.uint8) for m in MODS}


def _b64(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _call(addr, path, payload=None):
    """(status, body) of a GET (no payload) or a POST."""
    url = f"http://{addr[0]}:{addr[1]}{path}"
    data = None if payload is None else (payload if isinstance(payload, bytes)
                                         else json.dumps(payload).encode())
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _init(ecfg, seed, dtype):
    """Seeded weights as JAX (params, state) numpy trees: the port's
    ``editor_init`` through ``jax_tree_from_state_dict`` (JAX's eager
    ``editor_init`` takes ~10 s on the CPU at float64)."""
    from editor_tpu_torch.models.init import editor_init
    from editor_tpu_torch.utils.jax_weights import jax_tree_from_state_dict

    model = editor_init(ecfg, seed=seed, device="cpu").to(dtype)
    return jax_tree_from_state_dict(model.state_dict(), ecfg)


@pytest.fixture(scope="module")
def servers(x64, jax_native_private):
    vit = JaxViTConfig(img_size=(64, 32), patch_size=16, stride_size=(16, 16), embed_dim=96,
                       depth=2, num_heads=4, mlp_ratio=2.0, camera=4)
    jcfg = JaxEditorConfig(num_classes=10, vit=vit, head_keep=2, frequency_keep=3,
                           use_pallas=False)
    params, state = _init(torch_editor_config(jcfg), seed=0, dtype=torch.float64)
    jconf, conf = JaxConfig(), Config()
    jconf.INPUT.SIZE_TEST = conf.INPUT.SIZE_TEST = (64, 32)
    jex = JaxFeatureExtractor(jconf, jcfg, jax.tree_util.tree_map(jnp.asarray, params),
                              jax.tree_util.tree_map(jnp.asarray, state), batch_size=4,
                              compute_dtype=jnp.float64)
    ex = FeatureExtractor(port_editor(jcfg, params, state), batch_size=4,
                          compute_dtype=torch.float64, input_cfg=conf.INPUT)
    gallery = _imgs(6, seed=2)
    cams = np.arange(6, dtype=np.int32) % 4
    pairs = []
    for ex_, index_cls, server_cls in ((jex, JaxGalleryIndex, JaxRetrievalServer),
                                       (ex, GalleryIndex, RetrievalServer)):
        idx = index_cls(ex_.feat_dim)
        idx.add(ex_(gallery, cams), pids=[10 + i for i in range(6)], camids=cams.tolist(),
                paths=[f"g{i}.png" for i in range(6)])
        server = server_cls(ex_, idx, port=0)
        server.start()
        pairs.append(server)
    yield {"jax": pairs[0], "port": pairs[1], "gallery": gallery, "ex": ex}
    for s in pairs:
        s.shutdown()


def _same_matches(got, ref):
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert (a["pid"], a["camid"], a["path"]) == (b["pid"], b["camid"], b["path"])
        assert abs(a["dist"] - b["dist"]) <= DIST_ATOL, (a, b)


def _both(servers, path, payload=None):
    return [_call(servers[k].address, path, payload) for k in ("port", "jax")]


def test_healthz_and_404(servers):
    (code, got), ref = _both(servers, "/healthz")
    assert code == 200 and (code, got) == ref
    assert got == {"status": "ok", "gallery_size": 6, "feat_dim": 288}
    for path, payload in (("/nope", None), ("/nope", {"images": {}})):
        got, ref = _both(servers, path, payload)
        assert got == ref == (404, {"error": "not found"})


def test_query_matches_jax(servers):
    g = servers["gallery"]
    for i, topk, reranking in ((3, 2, False), (0, 6, False), (5, 4, True)):
        req = {"images": {m: _b64(g[m][i]) for m in MODS}, "topk": topk, "camid": i % 4,
               "reranking": reranking}
        (code, got), (rcode, ref) = _both(servers, "/query", req)
        assert code == rcode == 200
        _same_matches(got["matches"], ref["matches"])
        assert len(got["matches"]) == topk and got["matches"][0]["pid"] == 10 + i
        assert got["matches"][0]["dist"] < 1e-6


def test_two_modal_fill(servers):
    """RGB alone fills NI and TI from it; RGB and NI fill TI from NI."""
    g, ex = servers["gallery"], servers["ex"]
    for mods in (("RGB",), ("RGB", "NI")):
        req = {"images": {m: _b64(g[m][1]) for m in mods}, "topk": 6}
        (code, got), (_, ref) = _both(servers, "/query", req)
        assert code == 200
        _same_matches(got["matches"], ref["matches"])
        filled = {"RGB": g["RGB"][1:2], "NI": g[mods[-1]][1:2], "TI": g[mods[-1]][1:2]}
        want = servers["port"].index.search(ex(filled, np.zeros(1, np.int32)), topk=6)[0]
        assert got["matches"] == want


def test_bad_requests_answer_400(servers):
    g = servers["gallery"]
    for payload in ({"images": {}}, {"images": {"NI": _b64(g["NI"][0])}}, b"{not json",
                    {"images": {m: _b64(g[m][0]) for m in MODS}, "topk": "many"}):
        got, ref = _both(servers, "/query", payload)
        assert got == ref and got[0] == 400 and list(got[1]) == ["error"], got
    # an image PIL cannot read: the same error type (the message names an object address)
    got, ref = _both(servers, "/query", {"images": {"RGB": base64.b64encode(b"xx").decode()}})
    assert got[0] == ref[0] == 400
    assert got[1]["error"].split(":")[0] == ref[1]["error"].split(":")[0]
    assert _call(servers["port"].address, "/healthz")[0] == 200  # still serving


def test_gallery_add_then_query(servers):
    new = _imgs(1, seed=9)
    req = {"images": {m: _b64(new[m][0]) for m in MODS}, "pid": 99, "camid": 2,
           "path": "new.png"}
    got, ref = _both(servers, "/gallery/add", req)
    assert got == ref == (200, {"ok": True, "gallery_size": 7})
    (code, got), (_, ref) = _both(servers, "/query", {"images": req["images"], "topk": 3,
                                                      "camid": 2})
    _same_matches(got["matches"], ref["matches"])
    assert got["matches"][0]["pid"] == 99 and got["matches"][0]["path"] == "new.png"


def test_concurrent_queries_equal_serial(servers):
    """8 handler threads at once, with a short switch interval so that the
    threads interleave often."""
    import sys

    addr = servers["port"].address
    rng = np.random.RandomState(4)
    reqs = []
    for i in range(8):
        imgs = {m: np.clip(servers["gallery"][m][i % 6].astype(int)
                           + rng.randint(-20, 21, (64, 32, 3)), 0, 255).astype(np.uint8)
                for m in MODS}
        reqs.append({"images": {m: _b64(v) for m, v in imgs.items()}, "topk": 4,
                     "camid": i % 4})
    serial = [_call(addr, "/query", r) for r in reqs]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(8) as pool:
            concurrent = list(pool.map(lambda r: _call(addr, "/query", r), reqs, timeout=120))
    finally:
        sys.setswitchinterval(interval)
    assert concurrent == serial and all(code == 200 for code, _ in serial)


def _rgbnt201_tree(root):
    """A seeded RGBNT201 layout: 3 identities, 6 train and 9 test items."""
    base = osp.join(root, "RGBNT201")
    protos = {pid: np.random.RandomState(50 + pid).randint(0, 255, (64, 32, 3))
              for pid in range(3)}
    for split, n in (("train_171", 6), ("test", 9)):
        for i in range(n):
            pid, cam = i % 3, (i // 3) % 2 + 1
            img = np.clip(protos[pid] + np.random.RandomState(i).randint(-10, 10, (64, 32, 3)),
                          0, 255).astype(np.uint8)
            for mod in MODS:
                p = osp.join(base, split, mod, f"{pid:06d}_cam{cam}_{split}{i}.jpg")
                os.makedirs(osp.dirname(p), exist_ok=True)
                Image.fromarray(img).save(p)


def test_build_service_matches_jax(x64, tmp_path, monkeypatch):
    import dataclasses

    import editor_tpu.models.editor as jax_editor_mod
    from editor_tpu.cli.serve import build_service as jax_build_service
    from editor_tpu.config import load_config as jax_load_config
    from editor_tpu.data.loader import ReIDDataModule as JaxDataModule
    from editor_tpu.engine.evaluate import build_eval_step
    from editor_tpu.models.editor import editor_config_from as jax_editor_config_from
    from editor_tpu.utils.torch_convert import export_editor_to_torch
    from editor_tpu_torch.cli.serve import build_service
    from editor_tpu_torch.config import load_config
    from editor_tpu_torch.models.editor import editor_config_from

    root = str(tmp_path / "data")
    _rgbnt201_tree(root)
    opts = ["DATASETS.ROOT_DIR", root, "MODEL.TRANSFORMER_TYPE", "vit_tiny_test",
            "INPUT.SIZE_TRAIN", "[64, 32]", "INPUT.SIZE_TEST", "[64, 32]",
            "MODEL.FREQUENCY_KEEP", "3", "TEST.IMS_PER_BATCH", "4",
            "DATALOADER.NUM_WORKERS", "2", "TPU.COMPUTE_DTYPE", "float64"]
    jcfg, cfg = jax_load_config(None, opts), load_config(None, opts)
    # JAX's plain XLA paths (its Pallas dispatch off the TPU computes parts
    # in float32); the port's kernel wrappers run their plain versions on
    # CPU tensors at the tensors' dtype
    monkeypatch.setattr(jax_editor_mod, "editor_config_from", lambda *a: dataclasses.replace(
        jax_editor_config_from(*a), use_pallas=False))
    jecfg = jax_editor_config_from(jcfg, 3, 2)
    params, state = _init(editor_config_from(cfg, 3, 2), seed=4, dtype=torch.float32)
    pth = str(tmp_path / "w.pth")
    export_editor_to_torch(params, state, jecfg, pth)
    # JAX's build_service builds a template with its eager editor_init and
    # replaces every value with the .pth's: hand it the same tree at once
    monkeypatch.setattr(jax_editor_mod, "editor_init", lambda key, ecfg: jax.tree_util.tree_map(
        jnp.asarray, (params, state)))

    jex, jidx = jax_build_service(jcfg, weight=pth, batch_size=4)
    idx_path = str(tmp_path / "gallery.npz")
    ex, idx = build_service(cfg, weight=pth, batch_size=4, save_index=idx_path, device="cpu")
    # RGBNT201's query and gallery are both the test split: 9 gallery items
    assert len(idx) == len(jidx) == 9 and idx.feat_dim == jidx.feat_dim == 288
    assert (idx._pids, idx._camids, idx._paths) == (jidx._pids, jidx._camids, jidx._paths)
    # JAX's extractor normalises the uint8 images inside its jit, at float64
    # under x64; the port's transform normalises in float32 (as JAX's
    # transform does outside x64): features ~2 float32 ulps apart
    np.testing.assert_allclose(idx._gallery(), jidx._gallery(), rtol=0, atol=1e-6)
    # against JAX's eval step on the float32-normalised batches of JAX's data
    # module: one float32 ulp, as tests/test_torch_serve.py
    step = build_eval_step(jax_editor_mod.editor_config_from(jcfg, 3, 2), jnp.float64)
    jdm = JaxDataModule(jcfg)
    ref = []
    for b in jdm.val_batches():
        batch = {m: jnp.asarray((b[m].astype(np.float32) / np.float32(255.0) - np.float32(0.5))
                                / np.float32(0.5)) for m in MODS}
        batch["camid"] = jnp.asarray(b["camid"])
        ref.append(np.asarray(step(jax.tree_util.tree_map(jnp.asarray, params),
                                   jax.tree_util.tree_map(jnp.asarray, state), batch)))
    ref = np.concatenate(ref)[jdm.num_query:len(jdm.val_items)]
    np.testing.assert_allclose(idx._gallery(), ref, rtol=2.0 ** -23, atol=1e-12)
    # the saved index reloads (the --index path) with equal search results
    ex2, idx2 = build_service(cfg, weight=pth, index_path=idx_path, batch_size=4, device="cpu")
    q = ex({m: v[:2] for m, v in _imgs(2, seed=8).items()})
    assert idx2.search(q, topk=3) == idx.search(q, topk=3)
    _same_matches(idx.search(q, topk=3)[0], jidx.search(jex(_imgs(2, seed=8)), topk=3)[0])
    with pytest.raises(ValueError, match="index dim"):
        small = GalleryIndex(8)
        small.add(np.zeros((1, 8), np.float32), [0])
        small.save(str(tmp_path / "small.npz"))
        build_service(cfg, weight=pth, index_path=str(tmp_path / "small.npz"), device="cpu")
