"""The port's training loop and inference engine against the JAX package's,
on the CPU at float64 (JAX x64 on, the compute dtype float64).

* ``do_inference``: the tiny EDITOR (depth 2, width 96) with JAX's weights
  (``state_dict_from_jax``) on the same normalised batches gives JAX's CMC
  exactly and its mAP within 1e-6 (both rank fp32 distances; the features
  differ only by float64 rounding).
* ``do_train``: both loops on the same in-memory splits through the same
  numpy ``decode_fn`` (4 train ids x 4 items, P x K = 4 x 2, so 2 steps an
  epoch), with ``MODEL.DROP_PATH`` 0 and ``INPUT.PROB``/``RE_PROB``/``PADDING``
  0 (the two packages' random streams differ), one epoch of two steps and
  ``OUTPUT_DIR`` "" (no checkpoints); the port's model starts from JAX's
  ``editor_init`` weights, dtypes included (x64 draws some heads in float64).
  Per-step loss within rtol 1e-7 (``tests/test_torch_train_step.py``'s
  tolerance), each parameter's change within 1e-6 of that tensor's largest
  change or one ulp of its weights in their dtype (the fp32 masters round
  the first change either way, which moves the second step's gradients by
  ~1e-7), the epoch's mAP within 1e-6 and its rank-1 equal.
* An exact resume on the CPU, with augmentation and drop path on: two epochs
  in one run equal one epoch plus a resumed epoch bit for bit, in every
  parameter and buffer (BN running stats, ``num_batches_tracked``, OCFR
  centers), the optimizer's slots and count, the generator and the logged
  losses.
* The checkpoint manager, and the distribution settings that raise without a
  process group.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editor_tpu.config import load_config as jax_load_config
from editor_tpu.data.datasets import DatasetSplits as JaxSplits
from editor_tpu.data.loader import ReIDDataModule as JaxDataModule
from editor_tpu.engine import loop as jax_loop
from editor_tpu.engine.evaluate import do_inference as jax_do_inference
from editor_tpu.models.editor import editor_config_from as jax_editor_config_from
from editor_tpu.models.editor import editor_init as jax_editor_init
from editor_tpu_torch.config import load_config
from editor_tpu_torch.data.datasets import DatasetSplits
from editor_tpu_torch.data.loader import ReIDDataModule
from editor_tpu_torch.engine import loop
from editor_tpu_torch.engine.evaluate import do_inference
from editor_tpu_torch.models.editor import Editor
from editor_tpu_torch.utils.checkpoint import CheckpointManager
from editor_tpu_torch.utils.jax_weights import state_dict_from_jax
from tests.torch_parity import port_editor, to_numpy_tree, torch_editor_config, x64  # noqa: F401

TINY = ["MODEL.TRANSFORMER_TYPE", "vit_tiny_test", "MODEL.PRETRAIN_CHOICE", "random",
        "INPUT.SIZE_TRAIN", "[64, 32]", "INPUT.SIZE_TEST", "[64, 32]",
        "MODEL.FREQUENCY_KEEP", "3", "DATALOADER.NUM_INSTANCE", "2",
        "DATALOADER.NUM_WORKERS", "2", "SOLVER.IMS_PER_BATCH", "8", "SOLVER.LOG_PERIOD", "1",
        "TEST.IMS_PER_BATCH", "5", "TPU.MESH_DATA", "1"]


def items(n_train_ids=4, per_id=4):
    """(train, query, gallery) item lists: ids 0.. for training; 4 other ids
    with one query in camera 0 and two gallery items in cameras 0 and 1."""
    train = [(("train", i), i // per_id, i % 2, -1) for i in range(n_train_ids * per_id)]
    query = [(("query", i), 50 + i, 0, -1) for i in range(4)]
    gallery = [(("gallery", i), 50 + i % 4, i // 4, -1) for i in range(8)]
    return train, query, gallery


def decode(item, size=(64, 32)):
    """Per-identity uint8 prototype plus noise, the same for every modality
    but for a fixed offset, from the item's key."""
    (kind, i), pid = item[0], item[1]
    proto = np.random.RandomState(1000 + pid).randint(0, 256, size + (3,))
    noise = np.random.RandomState(7 * i + len(kind)).randint(-25, 26, size + (3,))
    img = np.clip(proto + noise, 0, 255).astype(np.uint8)
    return [img, np.roll(img, 1, axis=0), np.roll(img, 2, axis=1)]


def _record_losses(build, losses, jax_side):
    """build_train_step wrapped so that each step appends its loss."""
    def wrapped(*a, **k):
        inner = build(*a, **k)
        if jax_side:
            def step(state, batch, epoch):
                state, m = inner(state, batch, epoch)
                losses.append(float(m["loss"]))
                return state, m
        else:
            def step(batch, epoch):
                m = inner(batch, epoch)
                losses.append(float(m["loss"]))
                return m
            step.generator = inner.generator
        return step
    return wrapped


def test_do_train_matches_jax(x64, monkeypatch):
    opts = TINY + ["MODEL.DROP_PATH", "0.0", "INPUT.PROB", "0.0", "INPUT.RE_PROB", "0.0",
                   "INPUT.PADDING", "0", "SOLVER.MAX_EPOCHS", "1", "SOLVER.EVAL_PERIOD", "1",
                   "SOLVER.SEED", "5", "TPU.COMPUTE_DTYPE", "float64", "OUTPUT_DIR", ""]
    train, query, gallery = items()
    jcfg, cfg = jax_load_config(None, opts), load_config(None, opts)
    jdm = JaxDataModule(jcfg, splits=JaxSplits(train, query, gallery, 4, 2), decode_fn=decode)
    dm = ReIDDataModule(cfg, splits=DatasetSplits(train, query, gallery, 4, 2),
                        decode_fn=decode)

    jecfg = jax_editor_config_from(jcfg, 4, 2)
    params0, state0 = jax_editor_init(jax.random.PRNGKey(5), jecfg)
    sd0 = state_dict_from_jax(to_numpy_tree(params0), to_numpy_tree(state0), jecfg)

    def init_from_jax(ecfg, seed, device):
        assert ecfg == torch_editor_config(jecfg) and seed == 5
        model = Editor(ecfg, device=device)
        model.load_state_dict({k: v.clone() for k, v in sd0.items()}, strict=True,
                              assign=True)  # JAX's dtypes too
        return model

    jlosses, losses = [], []
    monkeypatch.setattr(jax_loop, "build_train_step",
                        _record_losses(jax_loop.build_train_step, jlosses, True))
    monkeypatch.setattr(loop, "build_train_step",
                        _record_losses(loop.build_train_step, losses, False))
    monkeypatch.setattr(loop, "editor_init", init_from_jax)
    ref = jax_loop.do_train(jcfg, dm=jdm, max_steps_per_epoch=2)
    got = loop.do_train(cfg, dm=dm, max_steps_per_epoch=2, device="cpu")

    assert len(losses) == len(jlosses) == 2
    np.testing.assert_allclose(losses, jlosses, rtol=1e-7)
    assert abs(got["best"]["mAP"] - ref["best"]["mAP"]) <= 1e-6
    assert got["best"]["Rank-1"] == ref["best"]["Rank-1"]
    assert got["optimizer"].count == int(ref["state"].step) == 2
    ref_sd = state_dict_from_jax(to_numpy_tree(ref["state"].params),
                                 to_numpy_tree(ref["state"].model_state), jecfg)
    got_sd = got["model"].state_dict()
    for name, _ in got["model"].named_parameters():
        d_got = got_sd[name].numpy() - sd0[name].numpy()
        d_ref = ref_sd[name].numpy() - sd0[name].numpy()
        # the masters are JAX's dtypes (mostly fp32): the first step's change
        # rounds to one fp32 ulp either way, which moves the second step's
        # gradients by ~1e-7 of their size; biases whose gradient is zero by
        # symmetry move by ~1e-20 (atol 1e-15, as test_torch_train_step)
        ulp = np.spacing(np.abs(sd0[name].numpy()).max())
        np.testing.assert_allclose(d_got, d_ref, rtol=0, err_msg=name,
                                   atol=max(1e-6 * np.abs(d_ref).max(), ulp, 1e-15))


def test_do_inference_matches_jax(x64):
    cfg = jax_load_config(None, TINY + ["MODEL.DROP_PATH", "0.0"])
    jecfg = jax_editor_config_from(cfg, 4, 2)
    params, state = jax_editor_init(jax.random.PRNGKey(2), jecfg)
    params, state = to_numpy_tree(params), to_numpy_tree(state)
    model = port_editor(jecfg, params, state, dtype=torch.float32)
    _, query, gallery = items()
    rng = np.random.RandomState(3)
    batches = []
    val = query + gallery
    for lo in range(0, len(val), 4):
        chunk = val[lo:lo + 4]
        imgs = np.stack([decode(it) for it in chunk])  # [b, 3 mods, H, W, 3]
        imgs = (imgs / 255.0 - 0.5) / 0.5 + 0.01 * rng.randn(*imgs.shape)
        batch = {m: imgs[:, i] for i, m in enumerate(("RGB", "NI", "TI"))}
        batch["pid"] = np.asarray([it[1] for it in chunk], np.int32)
        batch["camid"] = np.asarray([it[2] for it in chunk], np.int32)
        batches.append(batch)
    cmc_ref, map_ref, *_ = jax_do_inference(
        jax.tree_util.tree_map(jnp.asarray, params), jax.tree_util.tree_map(jnp.asarray, state),
        jecfg, [{k: jnp.asarray(v) for k, v in b.items()} for b in batches], len(query),
        compute_dtype=jnp.float64)
    cmc, mAP, distmat, pids, camids, qf, gf = do_inference(
        model, [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches], len(query),
        compute_dtype=torch.float64)
    np.testing.assert_array_equal(cmc, np.asarray(cmc_ref))
    assert abs(mAP - float(map_ref)) <= 1e-6
    assert distmat.shape == (4, 8) and qf.shape == (4, 288) and gf.shape == (8, 288)


def _resume_cfg(out, epochs):
    return load_config(None, TINY + ["SOLVER.MAX_EPOCHS", str(epochs), "SOLVER.SEED", "3",
                                     "SOLVER.EVAL_PERIOD", "1", "SOLVER.CHECKPOINT_PERIOD", "1",
                                     "TPU.COMPUTE_DTYPE", "float32", "TPU.MESH_DATA", "-1",
                                     "OUTPUT_DIR", str(out)])


def _run(out, epochs):
    cfg = _resume_cfg(out, epochs)
    train, query, gallery = items(per_id=6)
    dm = ReIDDataModule(cfg, splits=DatasetSplits(train, query, gallery, 4, 2),
                        decode_fn=decode)
    return loop.do_train(cfg, dm=dm, device="cpu")


def _losses(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [(r["epoch"], r["iter"], r["loss"], r["acc"], r["lr"]) for r in recs if "loss" in r]


def test_resume_is_exact_on_cpu(tmp_path):
    """Augmentation (flip, pad-crop, erasing) and drop path 0.1 on: the
    generator's state decides every step."""
    whole = _run(tmp_path / "whole", 2)
    _run(tmp_path / "split", 1)
    resumed = _run(tmp_path / "split", 2)

    with open(tmp_path / "split" / "train_log.txt") as f:
        log = f.read()
    assert "Resumed from checkpoint step 3 (epoch 1)" in log
    assert "training on the one device cpu" in log
    assert _losses(tmp_path / "whole") == _losses(tmp_path / "split")
    a, b = whole["model"].state_dict(), resumed["model"].state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert int(b["FUSE_BN.num_batches_tracked"]) == 6
    assert b["FUSE_block.memory_cls.RGB_centers"].abs().sum() > 0
    oa, ob = whole["optimizer"].state_dict(), resumed["optimizer"].state_dict()
    assert oa["count"] == ob["count"] == 6
    for sa, sb in zip(oa["state"], ob["state"]):
        assert all(torch.equal(x, y) for x, y in zip(sa["buf"], sb["buf"]))
    assert torch.equal(whole["step"].generator.get_state(), resumed["step"].generator.get_state())
    assert sorted(os.listdir(tmp_path / "split" / "ckpt")) == ["step_000000003.pt",
                                                               "step_000000006.pt"]


def test_checkpoint_manager(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    for step in (1, 2, 3):
        assert mgr.save(step, {"x": torch.full((2,), float(step)), "epoch": step})
    assert not mgr.save(3, {"x": torch.zeros(2), "epoch": 0})  # already saved: kept
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    back = mgr.restore()
    assert back["epoch"] == 3 and torch.equal(back["x"], torch.full((2,), 3.0))
    assert mgr.restore(2)["epoch"] == 2
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


@pytest.mark.parametrize("opt", [["TPU.MESH_DATA", "2"], ["TPU.MESH_MODEL", "2"],
                                 ["TPU.ZERO_STAGE", "1"], ["TPU.GRAD_COMPRESSION", "fp16"],
                                 "mesh", ["TPU.ZERO_STAGE", "3"]])
def test_distribution_settings_raise(opt, tmp_path):
    """Without a process group: the data- and model-parallel settings, FSDP
    (``ZERO_STAGE`` 3) and tensor parallelism (``MESH_MODEL`` 2) among them,
    need a mesh (one process per device, see tests/test_torch_dp_*.py,
    tests/test_torch_fsdp.py and tests/test_torch_tp.py); a mesh must be a
    DeviceMesh."""
    cfg = load_config(None, TINY + ["OUTPUT_DIR", str(tmp_path)]
                      + (opt if isinstance(opt, list) else []))
    if opt == "mesh":
        err, match = TypeError, "DeviceMesh"
    else:
        err, match = ValueError, "needs a data-parallel mesh"
    with pytest.raises(err, match=match):
        loop.do_train(cfg, mesh=object() if opt == "mesh" else None, device="cpu")
    assert not os.listdir(tmp_path)  # raised before anything was written


def test_do_train_needs_a_device_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config(None, TINY + ["OUTPUT_DIR", ""])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.do_train(cfg)


@pytest.mark.parametrize("name", ["SGD", "AdamW"])
def test_optimizer_state_dict_resumes_exactly(name):
    """Three steps, a state_dict into a fresh optimizer over a copy of the
    weights, then two more steps on each: the same weights bit for bit
    (AdamW's bias correction rides on ``count``)."""
    from editor_tpu_torch.solver.optimizer import Optimizer

    gen = torch.Generator().manual_seed(0)
    grads = [[torch.randn(5, 3, generator=gen), torch.randn(3, generator=gen)]
             for _ in range(5)]

    def make(ws):
        return Optimizer([{"params": ws[:1], "lr_factor": 1.0, "weight_decay": 1e-4},
                          {"params": ws[1:], "lr_factor": 2.0, "weight_decay": 0.0}], name)

    def step(opt, ws, g):
        for w, gi in zip(ws, g):
            w.grad = gi.clone()
        opt.step(0.01)

    ws = [torch.randn(5, 3, generator=gen), torch.randn(3, generator=gen)]
    opt = make(ws)
    for g in grads[:3]:
        step(opt, ws, g)
    ws2 = [w.clone() for w in ws]
    opt2 = make(ws2)
    opt2.load_state_dict(opt.state_dict())
    assert opt2.count == 3
    for g in grads[3:]:
        step(opt, ws, g)
        step(opt2, ws2, g)
    assert all(torch.equal(a, b) for a, b in zip(ws, ws2))
    other = Optimizer([{"params": [torch.zeros(2)], "lr_factor": 1.0, "weight_decay": 0.0}], name)
    with pytest.raises(ValueError):
        other.load_state_dict(opt.state_dict())
