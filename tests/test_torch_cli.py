"""The port's command-line entry points and ImageNet import, on the CPU.

* ``cli.params`` prints 118.55 M for the flagship (exactly 118,547,944, as
  ``tests/test_cli.py``).
* ``cli.train`` on the synthetic RGBNT201 tree of ``tests/test_cli.py``
  (PIL decode, tiny backbone from a synthetic ImageNet file) writes its log,
  metrics, ``config.yaml`` and checkpoints; ``cli.test`` on its checkpoint
  directory gives the mAP the loop logged for that checkpoint's epoch.
* ``cli.test`` on a ``.pth`` written by JAX's ``export_editor_to_torch``
  gives JAX ``cli.test``'s CMC and mAP on the same file (compute dtype
  float64, JAX x64 on; CMC equal, mAP within 1e-6).
* ``load_imagenet_vit`` and ``resize_pos_embed`` on a synthetic ImageNet-layout
  ``.pth`` (224 px: a 14 x 14 grid, resized to the model's 4 x 2; a distilled
  file too) load JAX's numbers exactly, through ``state_dict_from_jax``.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from editor_tpu.config import load_config as jax_load_config
from editor_tpu.models.editor import editor_config_from as jax_editor_config_from
from editor_tpu.models.editor import editor_init as jax_editor_init
from editor_tpu.utils import torch_convert as jax_convert
from editor_tpu_torch.utils import torch_convert
from editor_tpu_torch.utils.jax_weights import state_dict_from_jax
from tests.test_cli import tiny_root  # noqa: F401  (fixture)
from tests.torch_parity import port_editor, to_numpy_tree, x64  # noqa: F401

TINY = ["MODEL.TRANSFORMER_TYPE", "vit_tiny_test", "MODEL.DROP_PATH", "0.0",
        "INPUT.SIZE_TRAIN", "[64, 32]", "INPUT.SIZE_TEST", "[64, 32]",
        "MODEL.FREQUENCY_KEEP", "3", "DATASETS.NAMES", "RGBNT201",
        "DATALOADER.NATIVE_DECODE", "False", "DATALOADER.NUM_WORKERS", "2",
        "TEST.IMS_PER_BATCH", "8"]


def _imagenet_file(path, depth=2, C=96, hidden=192, grid=14, distilled=False, seed=0):
    """A timm-layout ViT state_dict (plus the head, and a dist token when
    ``distilled``) with random values."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    n_tok = grid * grid + (2 if distilled else 1)
    sd = {"cls_token": r(1, 1, C), "pos_embed": r(1, n_tok, C),
          "patch_embed.proj.weight": r(C, 3, 16, 16), "patch_embed.proj.bias": r(C),
          "norm.weight": r(C), "norm.bias": r(C), "head.weight": r(1000, C), "head.bias": r(1000)}
    if distilled:
        sd.update({"dist_token": r(1, 1, C), "head_dist.weight": r(1000, C)})
    for i in range(depth):
        b = f"blocks.{i}."
        sd.update({b + "norm1.weight": r(C), b + "norm1.bias": r(C),
                   b + "attn.qkv.weight": r(3 * C, C), b + "attn.qkv.bias": r(3 * C),
                   b + "attn.proj.weight": r(C, C), b + "attn.proj.bias": r(C),
                   b + "norm2.weight": r(C), b + "norm2.bias": r(C),
                   b + "mlp.fc1.weight": r(hidden, C), b + "mlp.fc1.bias": r(hidden),
                   b + "mlp.fc2.weight": r(C, hidden), b + "mlp.fc2.bias": r(C)})
    torch.save({"model": sd}, path)
    return sd


def test_cli_params_flagship_exact(capsys):
    from editor_tpu_torch.cli.params import main
    n = main(["MODEL.TRANSFORMER_TYPE", "vit_base_patch16_224", "INPUT.SIZE_TRAIN",
              "[256, 128]", "MODEL.AL", "0"])
    assert n == 118_547_944, n
    assert "Number of parameters: 118.55 M" in capsys.readouterr().out


@pytest.mark.parametrize("distilled", [False, True])
def test_load_imagenet_vit_matches_jax(distilled, tmp_path):
    path = str(tmp_path / ("deit_distilled.pth" if distilled else "vit.pth"))
    file_sd = _imagenet_file(path, distilled=distilled)
    cfg = jax_load_config(None, TINY)
    jecfg = jax_editor_config_from(cfg, 4, 2)
    params, state = jax_editor_init(jax.random.PRNGKey(0), jecfg)
    model = port_editor(jecfg, to_numpy_tree(params), to_numpy_tree(state), dtype=torch.float32)
    before = {k: v.clone() for k, v in model.state_dict().items()}

    params = dict(params, BACKBONE=jax_convert.load_imagenet_vit(path, jecfg.vit,
                                                                 params["BACKBONE"]))
    ref = state_dict_from_jax(to_numpy_tree(params), to_numpy_tree(state), jecfg)
    loaded = torch_convert.load_imagenet_vit(path, model)
    got = model.state_dict()
    assert "pos_embed" in loaded and "blocks.1.mlp.fc2.bias" in loaded
    assert not any("head" in k or "dist" in k for k in loaded)
    for k, v in got.items():
        assert torch.equal(v, ref[k].to(v.dtype)), k
    # the file's weights arrived; the keys it lacks kept their values
    assert torch.equal(got["BACKBONE.base.blocks.0.attn.qkv.weight"],
                       file_sd["blocks.0.attn.qkv.weight"])
    for k in ("BACKBONE.base.sie_embed", "BACKBONE.base.fc.weight", "FUSE_HEAD.weight"):
        assert torch.equal(got[k], before[k]), k
    assert got["BACKBONE.base.pos_embed"].shape == (1, 9, 96)


def test_resize_pos_embed_matches_jax_and_interpolate():
    pe = np.random.RandomState(1).randn(1, 1 + 14 * 14, 8).astype(np.float32)
    got = torch_convert.resize_pos_embed(pe, (21, 10))
    np.testing.assert_array_equal(got, jax_convert.resize_pos_embed(pe, (21, 10)))
    grid = torch.from_numpy(pe[0, 1:]).reshape(1, 14, 14, 8).permute(0, 3, 1, 2)
    ref = torch.nn.functional.interpolate(grid, size=(21, 10), mode="bilinear",
                                          align_corners=False)
    # torch interpolates in fp32, numpy in float64 (values up to ~4: a few
    # fp32 ulps of 4.8e-7)
    np.testing.assert_allclose(got[0, 1:], ref.permute(0, 2, 3, 1).reshape(210, 8).numpy(),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[:, :1], pe[:, :1])


def test_cli_train_then_test(tiny_root, tmp_path):  # noqa: F811
    from editor_tpu_torch.cli.test import main as test_main
    from editor_tpu_torch.cli.train import main as train_main

    pth = str(tmp_path / "vit_imagenet.pth")
    _imagenet_file(pth)
    out = str(tmp_path / "out")
    opts = TINY + [
        "MODEL.PRETRAIN_CHOICE", "imagenet", "MODEL.PRETRAIN_PATH_T", pth,
        "DATASETS.ROOT_DIR", tiny_root, "DATALOADER.NUM_INSTANCE", "2",
        "SOLVER.IMS_PER_BATCH", "8", "SOLVER.MAX_EPOCHS", "2", "SOLVER.EVAL_PERIOD", "1",
        "SOLVER.CHECKPOINT_PERIOD", "1", "SOLVER.LOG_PERIOD", "1", "SOLVER.SEED", "7",
        "TPU.COMPUTE_DTYPE", "float32", "OUTPUT_DIR", out]
    result = train_main(["--device", "cpu"] + opts)
    assert np.isfinite(result["best"]["mAP"]) and result["best"]["mAP"] > 0.0
    for name in ("train_log.txt", "metrics.jsonl", "config.yaml"):
        assert os.path.exists(os.path.join(out, name)), name
    with open(os.path.join(out, "train_log.txt")) as f:
        assert "Loaded ImageNet backbone from " + pth in f.read()
    from editor_tpu_torch.config import load_config
    # config.yaml reads back (through yaml here) as the run's config
    assert load_config(os.path.join(out, "config.yaml")) == load_config(None, opts)
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == ["step_000000002.pt",
                                                             "step_000000004.pt"]
    with open(os.path.join(out, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["iter"] for r in recs if "loss" in r] == [1, 2, 1, 2]
    last_map = [r["mAP"] for r in recs if "mAP" in r][-1]

    cmc, mAP = test_main(["--device", "cpu"] + TINY + [
        "DATASETS.ROOT_DIR", tiny_root, "TPU.COMPUTE_DTYPE", "float32",
        "TEST.WEIGHT", os.path.join(out, "ckpt"), "OUTPUT_DIR", str(tmp_path / "eval")])
    assert mAP == last_map and len(cmc) == 8


def test_cli_test_on_jax_export_matches_jax(x64, tiny_root, tmp_path):  # noqa: F811
    from editor_tpu.cli.test import main as jax_test_main
    from editor_tpu_torch.cli.test import main as test_main

    cfg = jax_load_config(None, TINY)
    jecfg = jax_editor_config_from(cfg, 4, 2)
    params, state = jax_editor_init(jax.random.PRNGKey(9), jecfg)
    pth = str(tmp_path / "exported.pth")
    jax_convert.export_editor_to_torch(params, state, jecfg, pth)
    args = TINY + ["DATASETS.ROOT_DIR", tiny_root, "TPU.COMPUTE_DTYPE", "float64",
                   "TEST.WEIGHT", pth]
    cmc_ref, map_ref = jax_test_main(args + ["OUTPUT_DIR", str(tmp_path / "jax")])
    cmc, mAP = test_main(["--device", "cpu"] + args + ["OUTPUT_DIR", str(tmp_path / "port")])
    np.testing.assert_array_equal(cmc, np.asarray(cmc_ref))
    assert abs(mAP - map_ref) <= 1e-6
