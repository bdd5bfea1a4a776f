"""ZeRO-1, FSDP and gradient compression in one process on one device: the
port's ``do_train`` against the JAX package's on its 1 x 1 mesh, on the CPU
at float64 (JAX x64 on, the compute dtype float64).

With ``TPU.MESH_DATA`` -1 (the default) and no process group, JAX's
``do_train`` builds a mesh and runs ``ZERO_STAGE`` 1 or 3 or a
``GRAD_COMPRESSION`` on it; the port makes a gloo group of one rank, runs
the same steps on its 1 x 1 mesh and destroys the group. The JAX side gets
``make_mesh(1, 1, devices=jax.devices()[:1])`` (the conftest gives JAX 8
virtual CPU devices, over which ``MESH_DATA`` -1 would spread). The data,
weights and step recording are ``tests/test_torch_loop.py``'s
``test_do_train_matches_jax`` (one epoch of two steps, no augmentation, no
drop path, ``OUTPUT_DIR`` "").

* ZeRO-1 and FSDP: that test's tolerances (losses rtol 1e-7; each
  parameter's change within 1e-6 of that tensor's largest change or one ulp
  of its weights). No evaluation (``cli.train`` below evaluates at W = 1).
* int8 and PowerSGD still compress at W = 1, in both packages: the loss of
  each step within rtol 1e-7, each parameter's change within
  ``tests/test_torch_dp_ddp.py``'s ``STEP2_TOL`` of its largest (int8:
  8e-3, one quantisation step of 1/127 of a leaf's largest gradient;
  PowerSGD: 1e-5, its fp32 factors summed in other orders). PowerSGD starts
  from JAX's initial Q, as in that test. JAX's two runs share one DDP step
  compile: its reducer is ``tests/torch_dp_jax.py``'s ``switch_reducer``
  over the two (each branch JAX's own reducer) with the run's reducer
  selected in its state, as ``tests/test_torch_dp_ddp.py`` runs them.
* No group is left behind: after each run, after a run whose second step
  raises, and a group the caller made stays up.
* ``cli.train`` with ``TPU.ZERO_STAGE 1`` writes checkpoints that
  ``cli.test`` loads: its mAP is the loop's last logged mAP.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from editor_tpu.config import load_config as jax_load_config
from editor_tpu.data.datasets import DatasetSplits as JaxSplits
from editor_tpu.data.loader import ReIDDataModule as JaxDataModule
from editor_tpu.engine import loop as jax_loop
from editor_tpu.engine import train as jax_train
from editor_tpu.models.editor import editor_config_from as jax_editor_config_from
from editor_tpu.models.editor import editor_init as jax_editor_init
from editor_tpu.parallel import compression as jax_compression
from editor_tpu.parallel import ddp as jax_ddp
from editor_tpu.parallel.compression import Reducer as JaxReducer
from editor_tpu.parallel.mesh import make_mesh as jax_make_mesh
from editor_tpu_torch.config import load_config
from editor_tpu_torch.data.datasets import DatasetSplits
from editor_tpu_torch.data.loader import ReIDDataModule
from editor_tpu_torch.engine import loop
from editor_tpu_torch.models.editor import Editor
from editor_tpu_torch.parallel import compression
from editor_tpu_torch.utils.jax_weights import state_dict_from_jax
from tests.test_torch_dp_ddp import STEP2_TOL
from tests.test_torch_loop import TINY, _record_losses, decode, items
from tests.torch_dp_jax import switch_reducer
from tests.torch_parity import to_numpy_tree, x64  # noqa: F401

SETTINGS = {"zero1": ["TPU.ZERO_STAGE", "1"], "fsdp": ["TPU.ZERO_STAGE", "3"],
            "int8": ["TPU.GRAD_COMPRESSION", "int8"],
            "powersgd": ["TPU.GRAD_COMPRESSION", "powersgd"]}
ONE = TINY + ["TPU.MESH_DATA", "-1", "MODEL.DROP_PATH", "0.0", "INPUT.PROB", "0.0",
              "INPUT.RE_PROB", "0.0", "INPUT.PADDING", "0", "SOLVER.MAX_EPOCHS", "1",
              "SOLVER.SEED", "5", "SOLVER.EVAL_PERIOD", "9", "TPU.COMPUTE_DTYPE", "float64",
              "OUTPUT_DIR", ""]
COMPRESSED = ("int8", "powersgd")  # the settings that run JAX's DDP step
_JAX_DDP = {}  # the switch reducer and JAX's DDP step, made once a process
_JAX_INIT = {}  # JAX's editor_init at SOLVER.SEED 5, drawn once a process


def _jax_init_once(key, ecfg):
    """JAX's ``editor_init(PRNGKey(5), ecfg)``, drawn eagerly once and then
    handed out as copies (its loop and ``make_train_state`` each draw it,
    and its step donates what it is given)."""
    assert np.array_equal(np.asarray(key), np.asarray(jax.random.PRNGKey(5)))
    if ecfg not in _JAX_INIT:
        _JAX_INIT[ecfg] = jax_editor_init(key, ecfg)
    return jax.tree_util.tree_map(lambda x: x.copy(), _JAX_INIT[ecfg])


def _jax_ddp_switch(monkeypatch, name, losses):
    """JAX's ``do_train`` on the switch reducer with ``name`` selected, its
    DDP step built once a process and each step's loss recorded."""
    if "reducer" not in _JAX_DDP:
        _JAX_DDP["reducer"] = switch_reducer(COMPRESSED)
    red, which = _JAX_DDP["reducer"], COMPRESSED.index(name)
    chosen = JaxReducer(lambda t: dict(red.init(t), which=np.int32(which)), red.reduce,
                        red.name)
    monkeypatch.setattr(jax_compression, "make_reducer", lambda *a, **k: chosen)
    build = jax_ddp.build_ddp_train_step

    def once(*a, **k):
        if "step" not in _JAX_DDP:
            _JAX_DDP["step"] = build(*a, **k)
        return _JAX_DDP["step"]
    monkeypatch.setattr(jax_ddp, "build_ddp_train_step", _record_ddp(once, losses))


def _data(cfg, jax_side=False):
    train, query, gallery = items()
    if jax_side:
        return JaxDataModule(cfg, splits=JaxSplits(train, query, gallery, 4, 2), decode_fn=decode)
    return ReIDDataModule(cfg, splits=DatasetSplits(train, query, gallery, 4, 2),
                          decode_fn=decode)


def _powersgd_from(q0):
    """The port's ``make_reducer`` with PowerSGD's Q drawn as JAX's."""
    make = compression.make_reducer

    def patched(name, **kw):
        red = make(name, **kw)
        if name != "powersgd":
            return red

        def init(template):
            state = red.init(template)
            for k, v in state.items():
                v["q"] = torch.tensor(q0[k]).to(v["q"])
            return state
        return compression.Reducer(init, red.reduce, red.name, red.elementwise)
    return patched


class _Recorded:
    """A port step that appends each step's loss, its attributes (the DDP
    step's ``comm``, ``reducer``, ``generator``) read through."""

    def __init__(self, inner, losses):
        self.inner, self.losses = inner, losses

    def __call__(self, batch, epoch):
        m = self.inner(batch, epoch)
        self.losses.append(float(m["loss"]))
        return m

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _recording(build, losses):
    return lambda *a, **k: _Recorded(build(*a, **k), losses)


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_one_process_setting_matches_jax_on_a_1x1_mesh(setting, x64, monkeypatch):
    opts = ONE + SETTINGS[setting]
    jcfg, cfg = jax_load_config(None, opts), load_config(None, opts)
    jecfg = jax_editor_config_from(jcfg, 4, 2)
    for module in (jax_loop, jax_train):
        monkeypatch.setattr(module, "editor_init", _jax_init_once)
    params0, state0 = _jax_init_once(jax.random.PRNGKey(5), jecfg)
    sd0 = state_dict_from_jax(to_numpy_tree(params0), to_numpy_tree(state0), jecfg)

    def init_from_jax(ecfg, seed, device):
        model = Editor(ecfg, device=device)
        model.load_state_dict({k: v.clone() for k, v in sd0.items()}, strict=True, assign=True)
        return model

    jlosses, losses = [], []
    monkeypatch.setattr(jax_loop, "build_train_step",
                        _record_losses(jax_loop.build_train_step, jlosses, True))
    monkeypatch.setattr(loop, "build_train_step", _recording(loop.build_train_step, losses))
    monkeypatch.setattr(loop, "editor_init", init_from_jax)
    if setting in COMPRESSED:  # the DDP steps: record their losses
        from editor_tpu_torch.parallel import ddp
        monkeypatch.setattr(ddp, "build_ddp_train_step",
                            _recording(ddp.build_ddp_train_step, losses))
        _jax_ddp_switch(monkeypatch, setting, jlosses)
    if setting == "powersgd":
        q0 = {k: np.asarray(v["q"]) for k, v in _JAX_DDP["reducer"].init(params0)["ps"].items()}
        monkeypatch.setattr(compression, "make_reducer", _powersgd_from(q0))

    ref = jax_loop.do_train(jcfg, dm=_data(jcfg, True), max_steps_per_epoch=2,
                            mesh=jax_make_mesh(1, 1, devices=jax.devices()[:1]))
    assert not dist.is_initialized()
    got = loop.do_train(cfg, dm=_data(cfg), max_steps_per_epoch=2, device="cpu")
    assert not dist.is_initialized() and got["mesh"] is None

    assert len(losses) == len(jlosses) == 2
    np.testing.assert_allclose(losses, jlosses, rtol=1e-7)
    assert got["optimizer"].count == int(ref["state"].step) == 2
    ref_sd = state_dict_from_jax(to_numpy_tree(ref["state"].params),
                                 to_numpy_tree(ref["state"].model_state), jecfg)
    got_sd = got["model"].state_dict()
    tol = STEP2_TOL.get(setting, 1e-6)
    for name, _ in got["model"].named_parameters():
        d_got = got_sd[name].numpy() - sd0[name].numpy()
        d_ref = ref_sd[name].numpy() - sd0[name].numpy()
        ulp = np.spacing(np.abs(sd0[name].numpy()).max())
        np.testing.assert_allclose(d_got, d_ref, rtol=0, err_msg=f"{setting} {name}",
                                   atol=max(tol * np.abs(d_ref).max(), ulp, 1e-15))


def _record_ddp(build, losses):
    """JAX's ``build_ddp_train_step`` wrapped so that each step appends its
    loss (its step takes and returns a ``DDPState``)."""
    def wrapped(*a, **k):
        inner = build(*a, **k)

        def step(dd, batch, epoch):
            dd, m = inner(dd, batch, epoch)
            losses.append(float(m["loss"]))
            return dd, m
        return step
    return wrapped


def _zero1_run(out="", **extra):
    opts = TINY + ["TPU.MESH_DATA", "-1", "TPU.ZERO_STAGE", "1", "SOLVER.MAX_EPOCHS", "1",
                   "SOLVER.EVAL_PERIOD", "9", "TPU.COMPUTE_DTYPE", "float32", "OUTPUT_DIR", out]
    cfg = load_config(None, opts)
    return loop.do_train(cfg, dm=_data(cfg), device="cpu", **extra)


def test_no_group_is_left_behind(monkeypatch):
    """A run whose second step raises destroys its group; a group the caller
    made stays up (the run uses it: its mesh is returned)."""
    calls = []

    class Failing(_Recorded):
        def __call__(self, batch, epoch):
            if len(calls) == 1:
                raise RuntimeError("mid-epoch fault")
            return super().__call__(batch, epoch)

    build = loop.build_train_step
    with monkeypatch.context() as m:
        m.setattr(loop, "build_train_step", lambda *a, **k: Failing(build(*a, **k), calls))
        with pytest.raises(RuntimeError, match="mid-epoch fault"):
            _zero1_run()
    assert not dist.is_initialized()

    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1, rank=0)
    try:
        got = _zero1_run()
        assert dist.is_initialized() and got["mesh"] is not None
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("device, want", [("cuda", 3), ("cuda:1", 1)])
def test_one_rank_group_on_a_cuda_device_sets_its_index(monkeypatch, device, want):
    """``initialize_one_rank`` on a CUDA device makes the device current by
    its index before the NCCL group: 'cuda' (``cli.train --device cuda``)
    is the current device. CUDA and the group are stubbed: this checks the
    calls, not NCCL."""
    from editor_tpu_torch.parallel import multihost

    calls = []
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(("set", d)))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **k: calls.append(("group", backend, k["world_size"])))
    multihost.initialize_one_rank(torch.device(device))
    assert calls == [("set", want), ("group", "nccl", 1)]


def test_cli_train_zero1_then_cli_test(tmp_path):
    from editor_tpu_torch.cli.test import main as test_main
    from editor_tpu_torch.cli.train import main as train_main

    train, query, gallery = items()
    splits = DatasetSplits(train, query, gallery, 4, 2)
    out = str(tmp_path / "out")
    opts = TINY + ["TPU.MESH_DATA", "-1", "TPU.ZERO_STAGE", "1", "SOLVER.MAX_EPOCHS", "2",
                   "SOLVER.EVAL_PERIOD", "1", "SOLVER.CHECKPOINT_PERIOD", "1",
                   "TPU.COMPUTE_DTYPE", "float32", "OUTPUT_DIR", out]
    result = train_main(["--device", "cpu"] + opts, splits=splits, decode_fn=decode)
    assert not dist.is_initialized()
    with open(os.path.join(out, "train_log.txt")) as f:
        assert "ZeRO-1: optimizer slots partitioned over the 1 data ranks" in f.read()
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == ["step_000000002.pt",
                                                             "step_000000004.pt"]
    with open(os.path.join(out, "metrics.jsonl")) as f:
        maps = [r["mAP"] for r in map(json.loads, f) if "mAP" in r]
    assert result["best"]["mAP"] == max(maps) > 0
    cmc, mAP = test_main(["--device", "cpu"] + opts[:-2] + [
        "TEST.WEIGHT", os.path.join(out, "ckpt"), "OUTPUT_DIR", str(tmp_path / "eval")],
        splits=splits, decode_fn=decode)
    assert mAP == maps[-1] and len(cmc) == 8
