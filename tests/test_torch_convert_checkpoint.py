"""The port's checkpoint converter (``editor_tpu_torch/tools/convert_checkpoint.py``)
against the JAX package's ``tools/convert_checkpoint.py`` on the same seeded
``.pth`` files, on the CPU at ``MODEL.TRANSFORMER_TYPE vit_tiny_test``.

* A full reference-layout file (every key, BN statistics and OCFR centers
  drawn from a seed): the two ``.npz`` files have the same keys and equal
  arrays, bit for bit; the port's ``.npz`` loads into a model whose state is
  the file's.
* ``--backbone-only`` on timm-layout ViT files (a 14 x 14 ImageNet grid
  resized to the model's 4 x 2, and a ``distilled`` file whose second token
  is cut): the same keys and shapes; the backbone entries the file supplies
  equal bit for bit. The rest (``sie_embed``, ``fc``, the fusion block and
  the heads) is each package's own seeded init, JAX's ``PRNGKey(0)`` and the
  port's ``editor_init(seed=0)``, which differ.
* Strictness, as JAX's converter (both tools' loaders, the port's being
  ``utils.torch_convert.load_editor_pth``): a file without the OCFR centers
  and, with ``MODEL.AL 1``, without the AL head (with or without its BN)
  converts in both packages; the centers keep the init both packages share
  (zeros), the AL entries each package's own init (the AL BN's running
  mean is zeros in both), everything else equal. A file without a head, or with the
  AL head but not its BN, raises ``KeyError`` in both; a MoE config
  (``MODEL.MOE_EXPERTS 2``) ``ValueError`` in both.
"""

import numpy as np
import pytest
import torch

from editor_tpu_torch.config import load_config
from editor_tpu_torch.models.editor import editor_config_from
from editor_tpu_torch.models.init import editor_init
from editor_tpu_torch.tools import convert_checkpoint as port_tool
from editor_tpu_torch.utils.checkpoint import load_params_npz
from tests.test_torch_cli import _imagenet_file
from tools import convert_checkpoint as jax_tool

OPTS = ["MODEL.TRANSFORMER_TYPE", "vit_tiny_test", "INPUT.SIZE_TRAIN", "[64, 32]",
        "INPUT.SIZE_TEST", "[64, 32]", "MODEL.FREQUENCY_KEEP", "3"]
FLAGS = ["--num_classes", "4", "--camera_num", "2"]


def _reference_pth(path, opts=OPTS, drop=()):
    """A reference-layout EDITOR state dict with seeded values in every
    entry (BN statistics and OCFR centers too), saved under 'model' without
    the keys starting with any of ``drop``."""
    cfg = load_config(None, opts)
    model = editor_init(editor_config_from(cfg, 4, 2), seed=11, device="cpu")
    gen = torch.Generator().manual_seed(12)
    sd = {}
    for k, v in model.state_dict().items():
        if v.is_floating_point() and ("running" in k or "centers" in k):
            v = torch.rand(v.shape, generator=gen) + (0.5 if "var" in k else 0.0)
        sd[k] = v
    torch.save({"model": {k: v for k, v in sd.items() if not k.startswith(tuple(drop))}}, path)
    return sd


def _convert(tmp_path, pth, *extra, opts=OPTS):
    """Both tools on ``pth``: (JAX's .npz arrays, the port's)."""
    out = []
    for name, tool in (("jax", jax_tool), ("port", port_tool)):
        path = str(tmp_path / f"{name}.npz")
        dev = ["--device", "cpu"] if tool is port_tool else []
        tool.main(["--pth", str(pth), "--out", path, *FLAGS, *dev, *extra, *opts])
        with np.load(path) as f:
            out.append({k: f[k] for k in f.files})
    return out


def _assert_equal(ref, got, skip=(), values=True):
    """The same keys, shapes and dtypes; with ``values`` equal arrays but
    under the keys containing any of ``skip``."""
    assert sorted(ref) == sorted(got)
    for k in ref:
        assert ref[k].shape == got[k].shape and ref[k].dtype == got[k].dtype, k
        if values and not any(s in k for s in skip):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_full_file_matches_jax(tmp_path, capsys):
    pth = tmp_path / "editor.pth"
    sd = _reference_pth(pth)
    ref, got = _convert(tmp_path, pth)
    _assert_equal(ref, got)
    assert "kept the seeded init: none" in capsys.readouterr().out
    cfg = load_config(None, OPTS)
    model = load_params_npz(str(tmp_path / "port.npz"),
                            editor_init(editor_config_from(cfg, 4, 2), seed=3, device="cpu"))
    for k, v in model.state_dict().items():
        if "num_batches_tracked" not in k:
            assert torch.equal(v, sd[k]), k


@pytest.mark.parametrize("distilled", [False, True])
def test_backbone_only_matches_jax_on_the_file_keys(tmp_path, distilled):
    pth = tmp_path / ("deit_distilled.pth" if distilled else "vit.pth")
    _imagenet_file(str(pth), distilled=distilled)  # a 14 x 14 grid, the model's is 4 x 2
    ref, got = _convert(tmp_path, pth, "--backbone-only")
    own = ("['sie_embed']", "['fc']")  # the backbone's entries the file lacks
    _assert_equal({k: v for k, v in ref.items() if "['BACKBONE']" in k},
                  {k: v for k, v in got.items() if "['BACKBONE']" in k}, skip=own)
    _assert_equal(ref, got, values=False)  # the rest: the same keys and shapes only
    assert ref["['params']['BACKBONE']['pos_embed']"].shape == (1, 9, 96)
    assert not np.array_equal(ref["['params']['BACKBONE']['fc']['w']"],
                              got["['params']['BACKBONE']['fc']['w']"])


@pytest.mark.parametrize("drop", [("AL_HEAD.", "AL_BN."), ("AL_HEAD.",)])
def test_missing_centers_and_al_keep_the_init_in_both(tmp_path, capsys, drop):
    """Without ``AL_HEAD.weight`` neither package loads the AL BN, also
    where the file has it: it is not loaded and keeps the init."""
    opts = OPTS + ["MODEL.AL", "1"]
    pth = tmp_path / "no_centers.pth"
    _reference_pth(pth, opts, drop=("FUSE_block.memory_cls.", *drop))
    ref, got = _convert(tmp_path, pth, opts=opts)
    _assert_equal(ref, got, skip=("['AL_HEAD']", "['AL_BN']"))
    for who in ("rgb", "nir", "tir"):
        assert not got[f"['state']['ocfr']['{who}']"].any()  # both inits are zeros
    kept, _, unloaded = capsys.readouterr().out.partition("not loaded: ")
    assert "FUSE_block.memory_cls.RGB_centers" in kept and "AL_BN.weight" in kept
    assert ("AL_BN.weight" in unloaded) == ("AL_BN." not in drop)
    assert not got["['state']['bn']['AL_BN']['mean']"].any()  # the file's is random


@pytest.mark.parametrize("case", ["no_head", "al_head_without_bn", "moe"])
def test_refusals_match_jax(tmp_path, case):
    pth = tmp_path / "editor.pth"
    if case == "no_head":
        opts, err = OPTS, KeyError
        _reference_pth(pth, drop=("FUSE_HEAD.",))
    elif case == "al_head_without_bn":
        opts, err = OPTS + ["MODEL.AL", "1"], KeyError
        _reference_pth(pth, opts, drop=("AL_BN.",))
    else:
        opts, err = OPTS + ["MODEL.MOE_EXPERTS", "2"], ValueError
        _reference_pth(pth)
    for tool, dev in ((jax_tool, []), (port_tool, ["--device", "cpu"])):
        with pytest.raises(err):
            tool.main(["--pth", str(pth), "--out", str(tmp_path / "x.npz"), *FLAGS, *dev,
                       *opts])
