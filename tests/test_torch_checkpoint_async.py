"""Asynchronous checkpoints (``TPU.ASYNC_CHECKPOINT``) and the ``.npz``
weight files, on the CPU.

* An asynchronous save equals a synchronous one after ``torch.load``: every
  tensor ``torch.equal`` (model, optimizer slots, the generator state), the
  rest equal, also when the model, the slots and the generator change right
  after ``save`` returns (the payload was copied first).
* A writer's exception is raised at the next ``wait``, ``save`` or
  ``close``, once. ``restore``, ``all_steps`` and ``latest_step`` wait for a
  pending write; pruning keeps ``max_to_keep``.
* ``do_train`` with ``TPU.ASYNC_CHECKPOINT`` on resumes from its own
  checkpoint bit for bit against an uninterrupted run with it off
  (``tests/test_torch_loop.py``'s resume), and the two runs' files are equal
  after ``torch.load``.
* ``load_params_npz`` of a file that the JAX package's ``save_params_npz``
  wrote gives ``state_dict_from_jax``'s state_dict exactly, and the JAX
  package's ``load_params_npz`` reads the port's ``save_params_npz`` back to
  the same arrays (keys, shapes, dtypes, values), with and without the AL
  head.
"""

import os
import pickle

import jax
import numpy as np
import pytest
import torch

from editor_tpu.models.editor import EditorConfig as JaxEditorConfig
from editor_tpu.models.editor import editor_init as jax_editor_init
from editor_tpu.models.vit import ViTConfig as JaxViTConfig
from editor_tpu.utils.checkpoint import load_params_npz as jax_load_params_npz
from editor_tpu.utils.checkpoint import save_params_npz as jax_save_params_npz
from editor_tpu_torch.config import Config
from editor_tpu_torch.data.transforms import make_train_augment
from editor_tpu_torch.engine.train import build_train_step
from editor_tpu_torch.losses import make_loss
from editor_tpu_torch.models.editor import EditorConfig, vit_tiny_test_config
from editor_tpu_torch.models.init import editor_init
from editor_tpu_torch.solver import make_optimizer, make_scheduler
from editor_tpu_torch.utils.checkpoint import (CheckpointManager, load_params_npz,
                                               save_params_npz, train_state)
from editor_tpu_torch.utils.jax_weights import state_dict_from_jax
from tests.test_torch_loop import _losses, _resume_cfg, decode, items
from tests.torch_parity import jax_editor, port_editor


def _assert_same(a, b, path="payload"):
    """Nested payloads equal: tensors by torch.equal (dtype and shape too)."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


@pytest.fixture(scope="module")
def trained():
    """A tiny model, its optimizer with filled slots and the step's
    generator, after one train step on the CPU."""
    vit = vit_tiny_test_config(img_size=(64, 32), patch_size=16, stride_size=(16, 16), camera=4)
    model = editor_init(EditorConfig(num_classes=10, vit=vit, head_keep=2, frequency_keep=3),
                        seed=0, device="cpu")
    cfg = Config()
    opt = make_optimizer(cfg, model)
    step = build_train_step(model, opt, make_loss(cfg, 10), make_scheduler(cfg), 0.001,
                            torch.float32, augment=make_train_augment(cfg.INPUT))
    gen = torch.Generator().manual_seed(0)
    batch = {m: torch.randint(0, 256, (4, 64, 32, 3), generator=gen, dtype=torch.uint8)
             for m in ("RGB", "NI", "TI")}
    batch["pid"], batch["camid"] = torch.tensor([0, 0, 1, 1]), torch.tensor([0, 1, 2, 3])
    step(batch, 1)
    return model, opt, step.generator


def test_async_save_equals_sync_save_after_mutation(trained, tmp_path):
    model, opt, gen = trained
    sync = CheckpointManager(str(tmp_path / "sync"), use_async=False)
    assert sync.save(7, train_state(model, opt, gen, 2))
    mgr = CheckpointManager(str(tmp_path / "async"))
    assert mgr.use_async and mgr.save(7, train_state(model, opt, gen, 2))
    # the next step's writes, before the file is (surely) written
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
        for st in opt.state:
            for slots in st.values():
                for s in slots:
                    s.add_(1.0)
        model.FUSE_BN.running_mean.add_(1.0)
    state_before = gen.get_state()
    torch.rand(3, generator=gen)
    assert not torch.equal(gen.get_state(), state_before)
    mgr.wait()
    got = torch.load(mgr.path(7), map_location="cpu", weights_only=True)
    ref = torch.load(sync.path(7), map_location="cpu", weights_only=True)
    _assert_same(got, ref)
    assert sum(isinstance(v, torch.Tensor) for v in got["model"].values()) == len(
        model.state_dict())
    assert torch.equal(got["generator"], state_before)
    with torch.no_grad():  # undo, for the module's other tests
        for p in model.parameters():
            p.sub_(1.0)
        for st in opt.state:
            for slots in st.values():
                for s in slots:
                    s.sub_(1.0)
        model.FUSE_BN.running_mean.sub_(1.0)


def test_writer_error_is_raised_once(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.save(1, {"x": torch.ones(2), "bad": lambda: 0})  # not picklable
    with pytest.raises((pickle.PicklingError, AttributeError, TypeError)):
        mgr.wait()
    mgr.wait()  # raised once
    assert mgr.all_steps() == [] and not os.path.exists(mgr.path(1))
    # at the next save, and at close
    assert mgr.save(2, {"bad": lambda: 0})
    with pytest.raises((pickle.PicklingError, AttributeError, TypeError)):
        mgr.save(3, {"x": torch.ones(2)})
    assert mgr.save(3, {"x": torch.ones(2)})
    assert mgr.save(4, {"bad": lambda: 0})
    with pytest.raises((pickle.PicklingError, AttributeError, TypeError)):
        mgr.close()
    assert mgr.all_steps() == [3]


def test_pending_write_is_waited_for_and_pruned(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3, 4):
        assert mgr.save(step, {"x": torch.full((64, 64), float(step)), "epoch": step})
    assert mgr.restore()["epoch"] == 4  # waits for step 4
    assert not mgr.save(4, {"x": torch.zeros(1), "epoch": 0})
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    assert torch.equal(mgr.restore(3)["x"], torch.full((64, 64), 3.0))
    assert sorted(os.listdir(tmp_path)) == ["step_000000003.pt", "step_000000004.pt"]


def _run(out, epochs, use_async):
    from editor_tpu_torch.data.datasets import DatasetSplits
    from editor_tpu_torch.data.loader import ReIDDataModule
    from editor_tpu_torch.engine import loop

    cfg = _resume_cfg(out, epochs)
    cfg.TPU.ASYNC_CHECKPOINT = use_async
    train, query, gallery = items(per_id=6)
    dm = ReIDDataModule(cfg, splits=DatasetSplits(train, query, gallery, 4, 2),
                        decode_fn=decode)
    return loop.do_train(cfg, dm=dm, device="cpu")


def test_do_train_async_checkpoints_resume_exactly(tmp_path):
    """Two epochs with ASYNC_CHECKPOINT off; one epoch with it on, then a
    second resumed from that asynchronous checkpoint: the two runs' losses,
    models, optimizers and generators equal bit for bit, and so do their
    checkpoint files after torch.load."""
    whole = _run(tmp_path / "sync", 2, use_async=False)
    _run(tmp_path / "async", 1, use_async=True)
    resumed = _run(tmp_path / "async", 2, use_async=True)
    assert _losses(tmp_path / "sync") == _losses(tmp_path / "async")
    _assert_same(resumed["model"].state_dict(), whole["model"].state_dict())
    _assert_same(resumed["optimizer"].state_dict(), whole["optimizer"].state_dict())
    assert torch.equal(resumed["step"].generator.get_state(), whole["step"].generator.get_state())
    steps = sorted(os.listdir(tmp_path / "sync" / "ckpt"))
    assert steps == sorted(os.listdir(tmp_path / "async" / "ckpt")) and len(steps) == 2
    for name in steps:
        _assert_same(*(torch.load(tmp_path / d / "ckpt" / name, weights_only=True)
                       for d in ("async", "sync")))


@pytest.mark.parametrize("al", [False, True])
def test_params_npz_both_ways(al, tmp_path):
    vit = JaxViTConfig(img_size=(64, 32), patch_size=16, stride_size=(16, 16), embed_dim=96,
                       depth=2, num_heads=4, mlp_ratio=2.0, camera=4)
    jcfg = JaxEditorConfig(num_classes=10, vit=vit, head_keep=2, frequency_keep=3,
                           use_pallas=False, al=al)
    params, state = jax_editor(jcfg, seed=1, dtype=np.float32)
    path = str(tmp_path / "jax.npz")
    jax_save_params_npz(path, {"params": params, "state": state})
    # the JAX file into a port model with other weights
    model = port_editor(jcfg, *jax_editor(jcfg, seed=2, dtype=np.float32), dtype=torch.float32)
    assert load_params_npz(path, model) is model
    want = state_dict_from_jax(params, state, jcfg)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k].to(got[k].dtype)), k
    # the port's file into the JAX package's template
    out = str(tmp_path / "port.npz")
    save_params_npz(out, model)
    with np.load(path) as a, np.load(out) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    tp, ts = jax_editor_init(jax.random.PRNGKey(3), jcfg)
    back = jax_load_params_npz(out, {"params": tp, "state": ts})
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_ref = dict(jax.tree_util.tree_leaves_with_path({"params": params, "state": state}))
    assert len(flat_back) == len(flat_ref)
    for kp, leaf in flat_back:
        assert np.array_equal(np.asarray(leaf), flat_ref[kp]), jax.tree_util.keystr(kp)
    with pytest.raises(ValueError, match="params and state"):
        np.savez(str(tmp_path / "bad.npz"), **{"['x']": np.zeros(1)})
        load_params_npz(str(tmp_path / "bad.npz"), model)
