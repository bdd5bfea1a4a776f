"""The port's ``cli.export``, ``utils/visualize`` and ``cli.visualize``
against the JAX package's, on the CPU.

* ``cli.export`` of a port checkpoint directory (and of a ``.pth``: a round
  trip) writes the state_dict of JAX's ``export_editor_to_torch`` on the same
  weights: the same keys, values equal (``num_batches_tracked`` is 0-d in
  the port, [1] in JAX's file: values compared). ``cli.test`` on the
  exported file gives the checkpoint's CMC and mAP exactly.
* ``dump_eval_visualizations`` on the tiny EDITOR (depth 1) at float64 (JAX x64 on)
  writes JAX's file names with JAX's pixels, and ``cli.visualize`` on the
  synthetic RGBNT201 tree at float32 does the same. Each PNG is a min-max
  normalisation floored to uint8, so a value within rounding of an integer
  step may land on the other side: a pixel may differ by one step, on at
  most PIXEL_SHARE of a file's pixels (none seen at float64).
"""

import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from editor_tpu.config import load_config as jax_load_config
from editor_tpu.models.editor import EditorConfig as JaxEditorConfig
from editor_tpu.models.editor import editor_config_from as jax_editor_config_from
from editor_tpu.models.vit import ViTConfig as JaxViTConfig
from editor_tpu.utils.torch_convert import export_editor_to_torch
from editor_tpu.utils.visualize import dump_eval_visualizations as jax_dump
from editor_tpu_torch.config import load_config
from editor_tpu_torch.models.editor import editor_config_from
from editor_tpu_torch.models.init import editor_init
from editor_tpu_torch.utils.checkpoint import CheckpointManager
from editor_tpu_torch.utils.jax_weights import jax_tree_from_state_dict, state_dict_from_jax
from editor_tpu_torch.utils.visualize import dump_eval_visualizations
from tests.test_cli import tiny_root  # noqa: F401  (fixture)
from tests.torch_parity import port_editor, torch_editor_config, x64  # noqa: F401

TINY = ["MODEL.TRANSFORMER_TYPE", "vit_tiny_test", "MODEL.DROP_PATH", "0.0",
        "INPUT.SIZE_TRAIN", "[64, 32]", "INPUT.SIZE_TEST", "[64, 32]",
        "MODEL.FREQUENCY_KEEP", "3", "DATASETS.NAMES", "RGBNT201",
        "DATALOADER.NUM_WORKERS", "2", "TEST.IMS_PER_BATCH", "8",
        "TPU.COMPUTE_DTYPE", "float32"]
PIXEL_SHARE = 0.005


def _init(ecfg, seed, dtype=torch.float32):
    """Seeded weights as JAX (params, state) numpy trees: the port's
    ``editor_init`` through ``jax_tree_from_state_dict`` (JAX's eager
    ``editor_init`` takes ~10 s on the CPU)."""
    model = editor_init(ecfg, seed=seed, device="cpu").to(dtype)
    return jax_tree_from_state_dict(model.state_dict(), ecfg)


@pytest.fixture(scope="module")
def weights(tiny_root, tmp_path_factory):  # noqa: F811
    """JAX float32 weights for the tiny tree's config (4 ids, 2 cameras): a
    port checkpoint directory and JAX's exported .pth of them."""
    opts = TINY + ["DATASETS.ROOT_DIR", tiny_root]
    jecfg = jax_editor_config_from(jax_load_config(None, opts), 4, 2)
    params, state = _init(editor_config_from(load_config(None, opts), 4, 2), seed=6)
    tmp = tmp_path_factory.mktemp("weights")
    ckpt = str(tmp / "ckpt")
    mgr = CheckpointManager(ckpt)
    mgr.save(3, {"model": state_dict_from_jax(params, state, jecfg), "epoch": 1})
    mgr.close()
    pth = str(tmp / "jax_export.pth")
    ref = export_editor_to_torch(params, state, jecfg, pth)
    return {"ckpt": ckpt, "pth": pth, "ref": ref, "params": params, "state": state,
            "jecfg": jecfg, "opts": opts}


def _assert_export_equal(got, ref):
    assert got.keys() == ref.keys()
    for k in got:
        want = torch.as_tensor(np.asarray(ref[k]))
        if k.endswith("num_batches_tracked"):  # 0-d here, [1] in JAX's file
            assert got[k].shape == () and want.shape == (1,)
            want = want.reshape(())
        assert got[k].dtype == want.dtype and torch.equal(got[k], want), k


def test_export_matches_jax(weights, tmp_path):
    from editor_tpu_torch.cli.export import main

    for src in ("ckpt", "pth"):
        out = str(tmp_path / f"{src}.pth")
        sd = main(["--device", "cpu", "--out", out, "--num_classes", "4", "--camera_num", "2"]
                  + weights["opts"] + ["TEST.WEIGHT", weights[src]])
        _assert_export_equal(sd, weights["ref"])
        _assert_export_equal(torch.load(out, weights_only=True), weights["ref"])
    # the class and camera counts from the dataset on disk
    sd = main(["--device", "cpu", "--out", str(tmp_path / "ds.pth")] + weights["opts"]
              + ["TEST.WEIGHT", weights["ckpt"]])
    _assert_export_equal(sd, weights["ref"])
    with pytest.raises(SystemExit, match="TEST.WEIGHT is required"):
        main(["--device", "cpu", "--out", str(tmp_path / "none.pth")] + weights["opts"])


def test_cli_test_on_export_gives_the_checkpoints_map(weights, tmp_path):
    from editor_tpu_torch.cli.export import main as export_main
    from editor_tpu_torch.cli.test import main as test_main

    out = str(tmp_path / "export.pth")
    export_main(["--device", "cpu", "--out", out] + weights["opts"]
                + ["TEST.WEIGHT", weights["ckpt"]])
    cmc_a, map_a = test_main(["--device", "cpu"] + weights["opts"]
                             + ["TEST.WEIGHT", weights["ckpt"]])
    cmc_b, map_b = test_main(["--device", "cpu"] + weights["opts"] + ["TEST.WEIGHT", out])
    np.testing.assert_array_equal(cmc_a, cmc_b)
    assert map_a == map_b and 0.0 < map_a <= 1.0


def _pngs(out):
    return {f: np.asarray(Image.open(os.path.join(out, f))) for f in sorted(os.listdir(out))}


def _assert_pngs_close(got_dir, ref_dir):
    got, ref = _pngs(got_dir), _pngs(ref_dir)
    assert got.keys() == ref.keys()
    for name in got:
        a, b = got[name].astype(int), ref[name].astype(int)
        assert a.shape == b.shape, name
        diff = np.abs(a - b)
        assert diff.max() <= 1 and (diff > 0).mean() <= PIXEL_SHARE, (name, diff.max(),
                                                                        (diff > 0).mean())
    return got


def test_dump_eval_visualizations_matches_jax(x64, tmp_path):
    vit = JaxViTConfig(img_size=(64, 32), patch_size=16, stride_size=(16, 16), embed_dim=96,
                       depth=1, num_heads=4, mlp_ratio=2.0, camera=4)
    jcfg = JaxEditorConfig(num_classes=5, vit=vit, head_keep=2, frequency_keep=3,
                           use_pallas=False)
    params, state = _init(torch_editor_config(jcfg), seed=0, dtype=torch.float64)
    rng = np.random.RandomState(0)
    images = {m: rng.randn(2, 64, 32, 3) for m in ("RGB", "NI", "TI")}
    cams = np.array([0, 3], np.int32)
    ref_dir, got_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    ref_paths = jax_dump(ref_dir, jax.tree_util.tree_map(jax.numpy.asarray, params),
                         jax.tree_util.tree_map(jax.numpy.asarray, state), jcfg, images,
                         cam_ids=cams)
    got_paths = dump_eval_visualizations(got_dir, port_editor(jcfg, params, state), images,
                                         cam_ids=cams)
    assert [os.path.basename(p) for p in got_paths] == [os.path.basename(p) for p in ref_paths]
    assert len(got_paths) == 3 * 2 * 2 + 2
    got = _assert_pngs_close(got_dir, ref_dir)
    assert got["rollout_RGB_0.png"].shape == (64, 32, 3)
    assert all(np.array_equal(got[n], _pngs(ref_dir)[n]) for n in got)  # exact at float64


def test_cli_visualize_matches_jax(weights, tmp_path, monkeypatch):
    import editor_tpu.models.editor as jax_editor_mod
    from editor_tpu.cli.visualize import main as jax_main
    from editor_tpu_torch.cli.visualize import main

    # JAX's CLI builds a template with its eager editor_init (~10 s here) and
    # replaces every value with the .pth's: hand it the same tree at once
    monkeypatch.setattr(jax_editor_mod, "editor_init", lambda key, ecfg: jax.tree_util.tree_map(
        jax.numpy.asarray, (weights["params"], weights["state"])))

    ref = jax_main(["--num_images", "3"] + weights["opts"]
                   + ["TEST.WEIGHT", weights["pth"], "OUTPUT_DIR", str(tmp_path / "jax")])
    got = main(["--device", "cpu", "--num_images", "3"] + weights["opts"]
               + ["TEST.WEIGHT", weights["ckpt"], "OUTPUT_DIR", str(tmp_path / "port")])
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in ref]
    assert len(got) == 3 * 3 * 2 + 3
    _assert_pngs_close(str(tmp_path / "port" / "visualizations"),
                       str(tmp_path / "jax" / "visualizations"))
    assert os.path.exists(tmp_path / "port" / "visualize_log.txt")
