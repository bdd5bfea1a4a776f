"""ZeRO-1, FSDP and gradient compression on a tensor-parallel mesh (data 2 x
model 2) in the port against the JAX package, on the CPU at float64: the
port's four ranks are one gloo launch (``tests/torch_dp.py``) that runs
every scenario of this file in turn, JAX runs on the conftest's virtual CPU
devices (``tests/torch_dp_jax.py``: the tiny config and batch, B = 8 as 4
ids x 2, drop path 0, two SGD steps from JAX's weights).

* ZeRO-1 and FSDP against JAX's ``build_train_step`` on the (2, 2) mesh with
  ``zero1_state_shardings`` or ``fsdp_state_shardings`` (and
  ``gather_params_compute``) of the shard-major state, as JAX's loop builds
  them: the losses and every parameter, BN statistic and OCFR center at
  ``test_torch_tp.py``'s tolerances (loss rtol 1e-7, each parameter's change
  within 1e-7 of its largest change), the gathered canonical state the same
  on every rank. ZeRO-1 equals the port's plain TP step bit for bit, with
  and without ``grad_accum=2``; FSDP equals it within 1e-12 (the same sums,
  reduce-scattered) and is the same step without ``gather_params_compute``
  (bit for bit); each rank's blocks are ``shard_params`` of the gathered
  model, and its parameter storage between steps is ``param_memory_bytes``
  of the cut model over the data axis. At the flagship's shapes that is
  159.0 MB a rank in fp32 against JAX's 258.2 MB per device (exact).
* ``int8`` and ``powersgd`` compression against JAX's
  ``build_ddp_train_step`` on a data-2 mesh with canonical weights (PowerSGD
  from JAX's initial Q), at ``test_torch_dp_ddp.py``'s tolerances: step 1 at
  1e-7 (PowerSGD 1e-5: fp32 factors summed in other orders), step 2 within
  one step of the reducer's grid (``STEP2_TOL``); the reducer's state is the
  canonical leaves'. fp16, an elementwise reducer, reduces each rank's
  shards in place: bit for bit what it gives on the canonical leaves.
* JAX's fault: its ``do_train`` runs the DDP step on the shard-major qkv
  columns without a ``tp_mesh``; that step's loss differs from the same
  step on canonical weights, which the port's TP + compression step equals.
* Checkpoints written at (2, 2) resume there bit for bit (ZeRO-1, FSDP) and
  in one process within 1e-12.
* ``do_train`` (``cli.train`` on in-memory data, float32, no random draws)
  at ``TPU.MESH_MODEL 2`` on the four ranks: with ``ZERO_STAGE 1`` the
  losses are finite, the checkpoint canonical (a one-device model's keys and
  shapes, its slots), and the epoch-1 checkpoint resumes at (2, 2) bit for
  bit, at (4, 1) and in one process with the uninterrupted run's epoch-2
  losses (rtol 1e-5: float32 sums in another order); ``cli.test`` in one
  process gives the mAP the run logged (1e-6). With ``GRAD_COMPRESSION
  powersgd`` the checkpoint holds the canonical Q and the two data ranks'
  error feedback and resumes at (2, 2) with the uninterrupted run's losses
  bit for bit (one process cannot run the local-batch step's mining).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from tests.test_torch_dp_ddp import STEP2_TOL
from tests.torch_dp import finish, start_ranks
from tests.torch_dp_jax import (close_to_jax, jax_ddp, jax_ddp_step, jax_setup,
                                jax_state_dict, jax_tp, make_batch, port_inputs)
from tests.torch_parity import x64  # noqa: F401

W = 4  # data 2 x model 2
RUNS = {
    "tp": {"kind": "global", "tp": 2},
    "zero1": {"kind": "zero1", "tp": 2, "save_after": 1, "save_path": "zero1.pt"},
    "fsdp": {"kind": "fsdp", "tp": 2, "save_after": 1, "save_path": "fsdp.pt"},
    "tp_accum": {"kind": "global", "tp": 2, "grad_accum": 2},
    "zero1_accum": {"kind": "zero1", "tp": 2, "grad_accum": 2},
    "fsdp_accum": {"kind": "fsdp", "tp": 2, "grad_accum": 2},
    "fsdp_no_gather": {"kind": "fsdp", "tp": 2, "gather": False},
    "zero1_resumed": {"kind": "zero1", "tp": 2, "steps": 1, "resume": "zero1.pt"},
    "fsdp_resumed": {"kind": "fsdp", "tp": 2, "steps": 1, "resume": "fsdp.pt"},
    "int8": {"kind": "ddp", "tp": 2, "reducer": "int8"},
    "powersgd": {"kind": "ddp", "tp": 2, "reducer": "powersgd"},
    "fp16": {"kind": "ddp", "tp": 2, "reducer": "fp16"},
    "fp16_whole": {"kind": "ddp", "tp": 2, "reducer": "fp16", "whole": True},
}

TINY = ["MODEL.TRANSFORMER_TYPE", "vit_tiny_test", "MODEL.PRETRAIN_CHOICE", "random",
        "INPUT.SIZE_TRAIN", "[64, 32]", "INPUT.SIZE_TEST", "[64, 32]",
        "MODEL.FREQUENCY_KEEP", "3", "DATALOADER.NUM_INSTANCE", "2",
        "DATALOADER.NUM_WORKERS", "2", "SOLVER.IMS_PER_BATCH", "8", "SOLVER.LOG_PERIOD", "1",
        "SOLVER.CHECKPOINT_PERIOD", "1", "TEST.IMS_PER_BATCH", "5",
        "TPU.COMPUTE_DTYPE", "float32",
        # no random draws: a resume at another layout draws nothing
        "INPUT.PROB", "0", "INPUT.RE_PROB", "0", "INPUT.PADDING", "0", "MODEL.DROP_PATH", "0"]
ZERO1 = ["TPU.MESH_MODEL", "2", "TPU.ZERO_STAGE", "1"]
POWERSGD = ["TPU.MESH_MODEL", "2", "TPU.GRAD_COMPRESSION", "powersgd"]


def _argv(out, epochs, opts):
    return (["--device", "cpu"] + TINY + list(opts)
            + ["SOLVER.MAX_EPOCHS", str(epochs), "OUTPUT_DIR", out])


def _ckpt(out, step):
    return os.path.join(out, "ckpt", f"step_{step:09d}.pt")


def _records(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _losses(out, epoch=None):
    return [r["loss"] for r in _records(out)
            if "loss" in r and (epoch is None or r["epoch"] == epoch)]


@pytest.fixture(scope="module")
def launch(x64, tmp_path_factory):
    """The one launch of four ranks (the step scenarios, then the loops),
    started before any JAX oracle; :func:`_ranks` waits for it."""
    d = tmp_path_factory.mktemp("tp_zero")
    jcfg, _, _, state = jax_setup()
    comm0 = jax_ddp_step(2)[1].init(state.params)["ps"]  # PowerSGD's initial Q
    runs = []
    for name, run in RUNS.items():
        run = {k: (str(d / v) if k in ("save_path", "resume") else v) for k, v in run.items()}
        if name == "powersgd":
            run["q0"] = {k: np.asarray(v["q"]) for k, v in comm0.items() if "['fc']" not in k}
        runs.append(run)
    out = {n: str(d / n) for n in ("z", "z4", "z22", "p", "p22")}
    loops = [{"argv": _argv(out["z"], 2, ZERO1)},
             {"argv": _argv(out["z4"], 2, ["TPU.ZERO_STAGE", "1"]),
              "seed_ckpt": _ckpt(out["z"], 2)},
             {"argv": _argv(out["z22"], 2, ZERO1), "seed_ckpt": _ckpt(out["z"], 2)},
             {"argv": _argv(out["p"], 2, POWERSGD)},
             {"argv": _argv(out["p22"], 2, POWERSGD), "seed_ckpt": _ckpt(out["p"], 2)}]
    inp = port_inputs(jcfg, state, make_batch())
    handle = {"launch": start_ranks("several", W, d, {"timeout_s": 120, "parts": [
        ("train", dict(inp, runs=runs)), ("loop_runs", {"runs": loops})]}),
        "inp": inp, "dir": d, "out": out, "compressed": set(runs[-3]["q0"])}
    yield handle
    for p in handle["launch"][1]:  # a test that failed before finishing
        if p.poll() is None:
            p.kill()
            p.wait()


def _ranks(launch):
    """Each rank's (step runs by name, loop results)."""
    if "got" not in launch:
        got = finish(launch["launch"], timeout=400)
        launch["got"] = [(dict(zip(RUNS, steps)), loops) for steps, loops in got]
    return launch["got"]


def _same_everywhere(got, name, sd0):
    for r in range(1, W):
        assert got[r][0][name]["loss"] == got[0][0][name]["loss"], name
        assert all(torch.equal(got[r][0][name]["sd"][k], got[0][0][name]["sd"][k])
                   for k in sd0), name


def _bit_for_bit(a, b):
    assert a["loss"] == b["loss"]
    assert all(torch.equal(a["sd"][k], v) for k, v in b["sd"].items())


def _close(a, b, tol=1e-12):
    np.testing.assert_allclose(a["loss"], b["loss"], rtol=tol)
    for k, v in b["sd"].items():
        np.testing.assert_allclose(a["sd"][k].numpy(), v.numpy(), rtol=tol, atol=tol,
                                   err_msg=k)


def test_zero1_on_the_tp_mesh_matches_jax_and_the_tp_step(launch):
    jcfg, _, _, state = jax_setup()
    batch = make_batch()
    ref_losses, ref_state = jax_tp(state, batch, 2, 2, layout="zero1")
    got = _ranks(launch)
    sd0 = launch["inp"]["sd"]
    runs = got[0][0]
    assert close_to_jax(runs["zero1"], ref_losses, jax_state_dict(jcfg, ref_state), sd0)
    _same_everywhere(got, "zero1", sd0)
    _bit_for_bit(runs["zero1"], runs["tp"])
    _bit_for_bit(runs["zero1_accum"], runs["tp_accum"])
    for r in range(W):  # a rank keeps its part of its shards' slots
        total = got[r][0]["zero1"]["slot_bytes_total"]
        per = [got[q][0]["zero1"]["slot_bytes"] for q in range(W) if q % 2 == r % 2]
        assert sum(per) == total and max(per) <= 0.6 * total, (per, total)


def _cut_meta(model, tp):
    """``model`` (on the meta device) with each backbone block's Linears cut
    to a tensor-parallel rank's shapes, as ``shard_editor`` cuts them."""
    from editor_tpu_torch.parallel import tp as tpm
    full = {n: p for n, p in model.named_parameters() if tpm.shard_dim(n) is not None}
    for name, block in tpm._cut(full, tp, 0).items():
        owner, attr = name.rsplit(".", 1)
        mod = model.get_submodule(owner)
        setattr(mod, attr, nn.Parameter(block, requires_grad=getattr(mod, attr).requires_grad))
    return model


def test_fsdp_on_the_tp_mesh_matches_jax_and_the_tp_step(launch):
    from editor_tpu_torch.models.editor import Editor
    from editor_tpu_torch.parallel.fsdp import param_memory_bytes
    jcfg, _, _, state = jax_setup()
    batch = make_batch()
    ref_losses, ref_state = jax_tp(state, batch, 2, 2, layout="fsdp")
    got = _ranks(launch)
    sd0 = launch["inp"]["sd"]
    runs = got[0][0]
    assert close_to_jax(runs["fsdp"], ref_losses, jax_state_dict(jcfg, ref_state), sd0)
    _same_everywhere(got, "fsdp", sd0)
    _close(runs["fsdp"], runs["tp"])
    _close(runs["fsdp_accum"], runs["tp_accum"])
    _bit_for_bit(runs["fsdp_no_gather"], runs["fsdp"])  # the layout, not the flag
    cut = _cut_meta(Editor(launch["inp"]["ecfg"], device="meta").to(torch.float64), 2)
    held = param_memory_bytes(cut, True, 2)
    assert held < param_memory_bytes(cut, True, 1)
    for r in range(W):
        run = got[r][0]["fsdp"]
        assert run["param_bytes"] == [held] * 2, (run["param_bytes"], held)
        assert run["shards"][-1] and all(torch.equal(run["shard_params"][k], v)
                                         for k, v in run["shards"][-1].items())


def test_fsdp_tp_bytes_at_the_flagship():
    """A rank's parameter storage on a (2, 2) mesh at the flagship (fp32):
    the cut model over 2 data ranks, against JAX's ``param_memory_bytes``
    per device (the whole leaves over 'data')."""
    from editor_tpu.config import Config as JaxConfig
    from editor_tpu.models.editor import editor_config_from as jax_editor_config_from
    from editor_tpu.models.editor import editor_init as jax_editor_init
    from editor_tpu.parallel.fsdp import param_memory_bytes as jax_param_memory_bytes
    from editor_tpu_torch.config import Config
    from editor_tpu_torch.models.editor import Editor, editor_config_from
    from editor_tpu_torch.parallel.fsdp import param_memory_bytes

    class _Mesh:
        shape = {"data": 2, "model": 2}

    model = Editor(editor_config_from(Config(), 171, 15), device="meta")
    whole = param_memory_bytes(model, False, 1)
    cut = _cut_meta(model, 2)
    params = jax.eval_shape(lambda k: jax_editor_init(k, jax_editor_config_from(
        JaxConfig(), 171, 15))[0], jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(  # float32, as without the module's x64
        lambda l: jax.ShapeDtypeStruct(l.shape, jnp.float32 if l.dtype == jnp.float64
                                       else l.dtype), params)
    assert (whole, param_memory_bytes(cut, True, 1), param_memory_bytes(cut, True, 2),
            jax_param_memory_bytes(params, True, _Mesh())) == (
        475700128, 305701792, 159023008, 258177952)


@pytest.mark.parametrize("name", ["int8", "powersgd"])
def test_compressed_tp_step_matches_jax_ddp_on_canonical_weights(launch, name):
    jcfg, _, _, state = jax_setup()
    losses, jstates, _ = jax_ddp(state, make_batch(), 2, name)
    got = _ranks(launch)
    sd0 = launch["inp"]["sd"]
    run = got[0][0][name]
    step1 = dict(run, loss=run["loss"][:1])
    assert close_to_jax(step1, losses[:1], jax_state_dict(jcfg, jstates[0]), sd0,
                        param_tol=1e-5 if name == "powersgd" else 1e-7, what=name,
                        sd=run["sds"][0])
    assert close_to_jax(run, losses, jax_state_dict(jcfg, jstates[1]), sd0,
                        param_tol=STEP2_TOL[name], what=name)
    _same_everywhere(got, name, sd0)
    if name == "powersgd":  # the state on the canonical leaves, the same in a model group
        comm = run["comm"]
        assert set(comm) == launch["compressed"]
        qkv = "['BACKBONE']['blocks']['attn']['qkv']['w']"
        assert comm[qkv]["q"].shape == (3 * jcfg.vit.embed_dim, 4)
        for r in range(W):
            other = got[r][0][name]["comm"]
            assert all(torch.equal(other[k]["q"], v["q"]) for k, v in comm.items())
            mate = got[r ^ 1][0][name]["comm"]  # the other rank of its model group
            assert all(torch.equal(other[k]["error"], mate[k]["error"]) for k in comm)


def test_elementwise_reducer_reduces_the_shards_in_place(launch):
    got = _ranks(launch)
    for r in range(W):
        _bit_for_bit(got[r][0]["fp16"], got[r][0]["fp16_whole"])


def test_jax_do_train_compression_with_tp_mixes_heads(launch):
    """JAX's ``do_train`` permutes the qkv columns shard-major and then runs
    ``build_ddp_train_step``, which calls ``editor_apply`` without a
    ``tp_mesh``: each head reads other heads' q, k and v, and the loss is
    not the canonical step's. The port's TP + compression step is."""
    import dataclasses

    from editor_tpu.parallel.tp import permute_qkv_params
    jcfg, _, _, state = jax_setup()
    batch = make_batch()
    canonical = jax_ddp(state, batch, 2, "int8", steps=1)[0]
    permuted = dataclasses.replace(state, params=permute_qkv_params(
        state.params, jcfg.vit.num_heads, 2))
    as_do_train = jax_ddp(permuted, batch, 2, "int8", steps=1)[0]
    got = _ranks(launch)[0][0]["int8"]["loss"][:1]
    np.testing.assert_allclose(got, canonical, rtol=1e-7)
    assert abs(as_do_train[0] - canonical[0]) > 1e-3 * abs(canonical[0]), (
        as_do_train, canonical)


def test_tp_zero_checkpoints_resume_at_2x2_and_in_one_process(launch):
    from tests.torch_dp_worker import _train_run
    got = _ranks(launch)
    inp = launch["inp"]
    for name in ("zero1", "fsdp"):
        whole, resumed = got[0][0][name], got[0][0][name + "_resumed"]
        _bit_for_bit({"loss": resumed["loss"], "sd": resumed["sd"]},
                     {"loss": whole["loss"][1:], "sd": whole["sd"]})
        payload = torch.load(str(launch["dir"] / f"{name}.pt"), weights_only=False)
        assert all(payload["model"][k].shape == v.shape for k, v in inp["sd"].items())
        one = _train_run(dict(inp, kind="single", steps=1, resume=str(launch["dir"] /
                                                                       f"{name}.pt")), 0, 1)
        _close(one, {"loss": whole["loss"][1:], "sd": whole["sd"]})


def test_do_train_zero1_and_powersgd_on_the_tp_mesh(launch):
    from editor_tpu_torch.cli import test as cli_test
    from editor_tpu_torch.cli import train as cli_train
    from editor_tpu_torch.config import Config, load_config
    from editor_tpu_torch.data.datasets import DatasetSplits
    from editor_tpu_torch.models.editor import Editor, editor_config_from
    from editor_tpu_torch.solver import make_optimizer
    from tests.torch_dp import decode, items

    ranks = _ranks(launch)
    out = launch["out"]
    splits = DatasetSplits(*items(), 4, 2)
    one_model = Editor(editor_config_from(load_config(None, TINY), 4, 2), device="cpu")
    n_slots = [len(g["params"]) for g in make_optimizer(Config(), one_model).groups]
    z = _losses(out["z"])
    assert len(z) == 4 and np.isfinite(z).all()
    payload = torch.load(_ckpt(out["z"], 2), weights_only=False)  # canonical
    assert {k: v.shape for k, v in payload["model"].items()} == {
        k: v.shape for k, v in one_model.state_dict().items()}
    assert [len(st["buf"]) for st in payload["optimizer"]["state"]] == n_slots
    assert len(payload["generators"]) == W
    assert _losses(out["z22"]) == _losses(out["z"], epoch=2)  # at (2, 2): bit for bit
    np.testing.assert_allclose(_losses(out["z4"]), _losses(out["z"], epoch=2), rtol=1e-5)
    one = str(launch["dir"] / "z1")  # in one process
    os.makedirs(os.path.join(one, "ckpt"))
    os.link(_ckpt(out["z"], 2), _ckpt(one, 2))
    cli_train.main(_argv(one, 2, []), splits=splits, decode_fn=decode)
    np.testing.assert_allclose(_losses(one), _losses(out["z"], epoch=2), rtol=1e-5)
    with open(os.path.join(one, "train_log.txt")) as f:
        assert "Resumed from checkpoint step 2 (epoch 1)" in f.read()
    _, mAP = cli_test.main(["--device", "cpu"] + TINY + [
        "OUTPUT_DIR", "", "TEST.WEIGHT", os.path.join(out["z"], "ckpt")], splits=splits,
        decode_fn=decode)
    logged = [r["mAP"] for r in _records(out["z"]) if "mAP" in r]
    assert abs(mAP - logged[-1]) <= 1e-6 and all(r[1][0] == ranks[0][1][0] for r in ranks)
    # PowerSGD: canonical Q, the data ranks' error feedback, an exact resume
    p = _losses(out["p"])
    assert len(p) == 4 and np.isfinite(p).all()
    ckpt = torch.load(_ckpt(out["p"], 2), weights_only=False)
    assert {k: v.shape for k, v in ckpt["model"].items()} == {
        k: v.shape for k, v in one_model.state_dict().items()}
    comm = ckpt["comm"]
    qkv = "['BACKBONE']['blocks']['attn']['qkv']['w']"
    assert comm[qkv]["q"].shape == (3 * one_model.cfg.vit.embed_dim, 4)
    assert all(len(v["errors"]) == 2 for v in comm.values())
    assert _losses(out["p22"]) == _losses(out["p"], epoch=2)
    with open(os.path.join(out["p22"], "train_log.txt")) as f:
        log = f.read()
    assert "Resumed from checkpoint step 2" in log and "powersgd4 gradient reducer" in log
