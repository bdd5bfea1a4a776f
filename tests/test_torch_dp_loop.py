"""The port's data-parallel training and evaluation around the step, on the
CPU: gloo ranks spawned as processes (``tests/torch_dp.py``), each launch
with its own time limit.

* ZeRO-1 at W = 2 (float64, ``tests/torch_dp_jax.py``'s tiny config and
  batch): parameters and losses equal to the replicated global-batch step
  bit for bit, with SGD and with AdamW; each rank keeps at most 60% of the
  slot bytes and the two ranks all of them; the checkpoint after step 1 is in the single-device
  format and resumes at W = 2 (ZeRO-1) to step 2 of the uninterrupted run
  bit for bit and at W = 1 (one process, no mesh) within 1e-12.
* ``sharded_cmc_map`` at W = 2 and 3 with Q not divisible by W: CMC and mAP
  within 1e-6 of JAX's ``sharded_cmc_map`` on a mesh of W devices and of the
  port's ``R1mAPEvaluator`` on the same features.
* ``cli.train`` at W = 2, launched as ``torchrun`` would (``WORLD_SIZE``,
  ``RANK``, ``LOCAL_RANK``; a ``file://`` ``DIST_INIT_METHOD`` in place of
  ``MASTER_ADDR`` and ``MASTER_PORT``, so no TCP port is shared) with
  ``--device cpu`` (a gloo group) on in-memory data: rank 1 opens no file
  for writing; each step's two host shards are disjoint and make up, in
  rank order, the single-process run's global batch; the logged losses are
  finite; ``cli.test`` in one process on the run's checkpoint gives the mAP
  the W = 2 loop logged (1e-6); a second launch resumes at W = 2 and trains
  its second epoch.
* ``cli.train`` on two ranks with ZeRO-1 and with PowerSGD: the checkpoints
  keep the single-device optimizer format, every rank's generator and the
  reducer's state (each rank's error feedback), and the PowerSGD run
  resumes at W = 2; ``cli.test`` on two ranks gives the one-process mAP on
  every rank. The ZeRO-1 run accumulates over 2 microbatches: each rank
  loads its block of each, and the losses, weights and mAP are the
  one-process loop's with ``TPU.GRAD_ACCUM 2``.
* ``fail_fast``: rank 1 raises while rank 0 waits in a collective; both exit
  non-zero well inside the launch's time limit.
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editor_tpu.evals.metrics import sharded_cmc_map as jax_sharded_cmc_map
from editor_tpu.parallel.mesh import make_mesh as jax_make_mesh
from editor_tpu_torch.evals.metrics import R1mAPEvaluator
from tests.torch_dp import finish, run_ranks, start_ranks, wait_all
from tests.torch_dp_jax import jax_setup, make_batch, port_inputs
from tests.torch_parity import x64  # noqa: F401

def test_zero1_equals_replicated_and_resumes_at_any_world_size(x64, tmp_path):
    jcfg, _, _, state = jax_setup()
    inp = port_inputs(jcfg, state, make_batch())
    ckpt = str(tmp_path / "zero1_step1.pt")
    got = run_ranks("train", 2, tmp_path / "w2", dict(inp, runs=[
        {"kind": "global"},
        {"kind": "zero1", "save_after": 1, "save_path": ckpt},
        {"kind": "zero1", "steps": 1, "resume": ckpt},
        {"kind": "global", "optimizer": "AdamW"}, {"kind": "zero1", "optimizer": "AdamW"}]))
    rep, zero, resumed2, rep_adam, zero_adam = got[0]
    assert zero_adam["loss"] == rep_adam["loss"]
    for k, v in rep_adam["sd"].items():
        assert torch.equal(zero_adam["sd"][k], v), k
    assert zero["loss"] == rep["loss"]
    for k, v in rep["sd"].items():
        assert torch.equal(zero["sd"][k], v), k
    total = zero["slot_bytes_total"]
    per_rank = [got[r][1]["slot_bytes"] for r in range(2)]
    assert sum(per_rank) == total and max(per_rank) <= 0.6 * total, (per_rank, total)

    from editor_tpu_torch.config import Config
    from editor_tpu_torch.models.editor import Editor
    from editor_tpu_torch.solver import make_optimizer
    payload = torch.load(ckpt, weights_only=False)  # the single-device format
    full = make_optimizer(Config(), Editor(inp["ecfg"], device="cpu")).state_dict()
    assert [[t.shape for t in st["buf"]] for st in payload["optimizer"]["state"]] == [
        [t.shape for t in st["buf"]] for st in full["state"]]
    assert payload["epoch"] == 1 and len(payload["generators"]) == 2
    resumed1 = run_ranks("train", 1, tmp_path / "w1", dict(inp, runs=[
        {"kind": "single", "steps": 1, "resume": ckpt}]))[0][0]
    assert resumed2["loss"] == [zero["loss"][1]]
    for k, v in zero["sd"].items():
        assert torch.equal(resumed2["sd"][k], v), k
        np.testing.assert_allclose(resumed1["sd"][k].numpy(), v.numpy(), rtol=1e-12,
                                   atol=1e-12, err_msg=k)
    np.testing.assert_allclose(resumed1["loss"], [zero["loss"][1]], rtol=1e-12)


@pytest.mark.parametrize("W", [2, 3])
def test_sharded_cmc_map_matches_jax_and_the_evaluator(W, tmp_path):
    rng = np.random.RandomState(W)
    Q, G, D = 7, 12, 16
    qf = rng.randn(Q, D).astype(np.float32)
    gf = rng.randn(G, D).astype(np.float32)
    q_pids, g_pids = rng.randint(0, 3, Q), rng.randint(0, 3, G)
    q_cams, g_cams = rng.randint(0, 2, Q), rng.randint(0, 2, G)
    g_pids[:3] = (0, 1, 2)  # every query identity in the gallery
    g_cams[:3] = (1 - q_cams[:3]) if Q >= 3 else g_cams[:3]
    remove = (g_pids[None] == q_pids[:, None]) & (g_cams[None] == q_cams[:, None])
    launch = start_ranks("cmc", W, tmp_path, {"qf": qf, "gf": gf, "q_pids": q_pids,
                                              "g_pids": g_pids, "remove": remove})
    mesh = jax_make_mesh(data=W, model=1, devices=jax.devices()[:W])
    j_cmc, j_map = jax_sharded_cmc_map(jnp.asarray(qf), jnp.asarray(gf), jnp.asarray(q_pids),
                                       jnp.asarray(g_pids), jnp.asarray(remove), mesh)
    got = finish(launch)
    ev = R1mAPEvaluator(Q, feat_norm=False)
    ev.update(torch.from_numpy(np.concatenate([qf, gf])), np.concatenate([q_pids, g_pids]),
              np.concatenate([q_cams, g_cams]))
    e_cmc, e_map, *_ = ev.compute()
    for out in got:
        np.testing.assert_allclose(out["cmc"], np.asarray(j_cmc), rtol=0, atol=1e-6)
        np.testing.assert_allclose(out["cmc"][:len(e_cmc)], e_cmc, rtol=0, atol=1e-6)
        assert abs(out["mAP"] - float(j_map)) <= 1e-6 and abs(out["mAP"] - e_map) <= 1e-6


TINY = ["MODEL.TRANSFORMER_TYPE", "vit_tiny_test", "MODEL.PRETRAIN_CHOICE", "random",
        "INPUT.SIZE_TRAIN", "[64, 32]", "INPUT.SIZE_TEST", "[64, 32]",
        "MODEL.FREQUENCY_KEEP", "3", "DATALOADER.NUM_INSTANCE", "2",
        "DATALOADER.NUM_WORKERS", "2", "SOLVER.IMS_PER_BATCH", "8", "SOLVER.LOG_PERIOD", "1",
        "TEST.IMS_PER_BATCH", "5", "TPU.COMPUTE_DTYPE", "float32"]


def _argv(out, epochs, opts=()):
    return (["--device", "cpu"] + TINY + list(opts)
            + ["SOLVER.MAX_EPOCHS", str(epochs), "OUTPUT_DIR", out])


def _start_cli(tmp_path, name, out, epochs, opts=(), scenario="cli_train"):
    return start_ranks(scenario, 2, tmp_path / name, {"argv": _argv(out, epochs, opts)},
                       launcher=True)


def _cli(tmp_path, name, out, epochs, opts=(), scenario="cli_train"):
    return finish(_start_cli(tmp_path, name, out, epochs, opts, scenario), timeout=120)


def _records(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_train_on_two_ranks(tmp_path):
    from editor_tpu_torch.cli import test as cli_test
    from editor_tpu_torch.config import load_config
    from editor_tpu_torch.data.datasets import DatasetSplits
    from editor_tpu_torch.data.sampler import PKSampler
    from tests.torch_dp import decode, items

    out = str(tmp_path / "run")
    ranks = _cli(tmp_path, "first", out, 1)
    # rank 0 alone writes: the config, the log, the metrics, the checkpoints
    assert ranks[1]["opened"] == []
    written = {os.path.relpath(p, out) for p in ranks[0]["opened"]}
    assert {"config.yaml", "train_log.txt", "metrics.jsonl"} <= written
    assert any(p.startswith("ckpt/") for p in written)
    # the host shards: disjoint, in rank order the single-process global batches
    train, query, gallery = items()
    cfg = load_config(None, TINY)
    full = PKSampler(train, 8, 2, seed=cfg.SOLVER.SEED).epoch_indices(1)
    shards = [r["loads"] for r in ranks]
    assert [(s[0]["host_id"], s[0]["num_hosts"], s[0]["bs"]) for s in shards] == [
        (0, 2, 4), (1, 2, 4)]
    a, b = shards[0][0]["idxs"], shards[1][0]["idxs"]
    assert not set(a) & set(b)
    glob = np.concatenate([np.concatenate([a[i:i + 4], b[i:i + 4]]) for i in range(0, len(a), 4)])
    np.testing.assert_array_equal(glob, full)
    recs = _records(out)
    losses = [r["loss"] for r in recs if "loss" in r]
    assert len(losses) == len(full) // 8 and np.isfinite(losses).all()
    logged_map = [r["mAP"] for r in recs if "mAP" in r][-1]
    assert ranks[0]["best"] == ranks[1]["best"]  # every rank scored the same
    # one process scores the run's checkpoint as the two ranks did, and so
    # does cli.test on two ranks (started first), each scoring every row
    launch = _start_cli(tmp_path, "test", "", 1, ["TEST.WEIGHT", os.path.join(out, "ckpt")],
                        scenario="cli_test")
    splits = DatasetSplits(train, query, gallery, 4, 2)
    _, mAP = cli_test.main(["--device", "cpu"] + TINY + ["OUTPUT_DIR", "",
                                                         "TEST.WEIGHT", os.path.join(out, "ckpt")],
                           splits=splits, decode_fn=decode)
    assert abs(mAP - logged_map) <= 1e-6
    scored = finish(launch, timeout=120)
    assert scored[0]["mAP"] == scored[1]["mAP"] and abs(scored[0]["mAP"] - mAP) <= 1e-6
    # a second launch at W = 2 resumes and trains the second epoch
    again = _cli(tmp_path, "second", out, 2)
    recs = _records(out)
    assert [r["epoch"] for r in recs if "loss" in r] == [1] * len(losses) + [2] * len(losses)
    assert all(np.isfinite(r["loss"]) for r in recs if "loss" in r)
    with open(os.path.join(out, "train_log.txt")) as f:
        assert "Resumed from checkpoint step 2 (epoch 1)" in f.read()
    assert os.path.exists(os.path.join(out, "ckpt", "step_000000004.pt"))
    assert again[1]["opened"] == []


# no random draws (flip, crop, erasing, drop path): the ranks' generators
# then do not matter, and two ranks can be held against one process
NO_RANDOM = ["INPUT.PROB", "0", "INPUT.RE_PROB", "0", "INPUT.PADDING", "0",
             "MODEL.DROP_PATH", "0"]


def test_cli_train_zero1_and_powersgd_checkpoints(tmp_path):
    """The loop on two ranks with ``TPU.ZERO_STAGE 1`` and with
    ``TPU.GRAD_COMPRESSION powersgd``: finite losses; the checkpoints keep
    the single-device optimizer format (every slot), every rank's generator
    and, with PowerSGD, each compressed leaf's Q and both ranks' error
    feedback; the PowerSGD run resumes at W = 2 and trains its second
    epoch. The ZeRO-1 run accumulates over 2 microbatches (``TPU.GRAD_ACCUM
    2``, no random draws): each rank loads its block of each microbatch
    (``sampler.host_rows``), and its losses, weights and mAP are the
    one-process loop's on the same global batches (float32: the losses
    within rtol 1e-5 and the mAP within 1e-5; each weight's change within
    1e-3 of that tensor's largest change, or 1e-7 of the model's largest
    where a tensor's gradient is zero and its change rounding noise, ~1e-11;
    measured 2e-4 at most. Rows in the wrong microbatch move the losses by
    ~2% and the weights' changes by 0.3-1.2 of their size)."""
    from editor_tpu_torch.cli import train as cli_train
    from editor_tpu_torch.config import Config
    from editor_tpu_torch.models.editor import Editor, editor_config_from
    from editor_tpu_torch.config import load_config
    from editor_tpu_torch.data.datasets import DatasetSplits
    from editor_tpu_torch.data.sampler import PKSampler, host_rows
    from editor_tpu_torch.models.init import editor_init
    from editor_tpu_torch.solver import make_optimizer
    from tests.torch_dp import decode, items

    cfg = load_config(None, TINY)
    full = make_optimizer(Config(), Editor(editor_config_from(cfg, 4, 2), device="cpu"))
    n_slots = [len(g["params"]) for g in full.groups]
    accum = ["TPU.GRAD_ACCUM", "2"] + NO_RANDOM
    runs = (("zero1", ["TPU.ZERO_STAGE", "1"] + accum),
            ("powersgd", ["TPU.GRAD_COMPRESSION", "powersgd"]))
    launches = [_start_cli(tmp_path, name, str(tmp_path / name), 1, opts)
                for name, opts in runs]  # the two runs side by side
    for (name, opts), launch in zip(runs, launches):
        out = str(tmp_path / name)
        ranks = finish(launch, timeout=120)
        losses = [r["loss"] for r in _records(out) if "loss" in r]
        assert losses and np.isfinite(losses).all()
        ckpt = torch.load(os.path.join(out, "ckpt", "step_000000002.pt"), weights_only=False)
        assert [len(st["buf"]) for st in ckpt["optimizer"]["state"]] == n_slots
        assert len(ckpt["generators"]) == 2
        if name == "zero1":
            train, query, gallery = items()
            epoch = PKSampler(train, 8, 2, seed=cfg.SOLVER.SEED).epoch_indices(1)
            for r, rank in enumerate(ranks):
                load = rank["loads"][0]
                assert (load["grad_accum"], load["bs"]) == (2, 4)
                np.testing.assert_array_equal(load["idxs"], np.concatenate(
                    [epoch[b:b + 8][host_rows(8, r, 2, 2)] for b in range(0, len(epoch), 8)]))
            one = str(tmp_path / "one")
            cli_train.main(_argv(one, 1, accum), splits=DatasetSplits(train, query, gallery,
                                                                      4, 2), decode_fn=decode)
            recs, ref = _records(out), _records(one)
            np.testing.assert_allclose([r["loss"] for r in recs if "loss" in r],
                                       [r["loss"] for r in ref if "loss" in r], rtol=1e-5)
            np.testing.assert_allclose([r["mAP"] for r in recs if "mAP" in r],
                                       [r["mAP"] for r in ref if "mAP" in r], rtol=0, atol=1e-5)
            ref_sd = torch.load(os.path.join(one, "ckpt", "step_000000002.pt"),
                                weights_only=False)["model"]
            run_cfg = load_config(None, TINY + accum)
            sd0 = editor_init(editor_config_from(run_cfg, 4, 2), seed=run_cfg.SOLVER.SEED,
                              device="cpu").state_dict()
            moved = max(float((ref_sd[k] - v).abs().max()) for k, v in sd0.items()
                        if v.is_floating_point())
            for k, v0 in sd0.items():
                got, want = ckpt["model"][k], ref_sd[k]
                if not v0.is_floating_point():
                    assert torch.equal(got, want), k
                    continue
                d_ref = (want - v0).numpy()
                np.testing.assert_allclose((got - v0).numpy(), d_ref, rtol=0, err_msg=k,
                                           atol=max(1e-3 * np.abs(d_ref).max(), 1e-7 * moved))
        if name == "powersgd":
            comm = ckpt["comm"]
            assert comm and all(len(v["errors"]) == 2 and v["q"].shape[1] == 4
                                for v in comm.values())
            assert not all(torch.equal(v["errors"][0], v["errors"][1]) for v in comm.values())
            _cli(tmp_path, name + "_resumed", out, 2, opts)
            assert [r["epoch"] for r in _records(out) if "loss" in r] == [1, 1, 2, 2]
            with open(os.path.join(out, "train_log.txt")) as f:
                log = f.read()
            assert "Resumed from checkpoint step 2" in log and "powersgd4 gradient reducer" in log


def test_fail_fast_ends_every_rank(tmp_path):
    t0 = time.monotonic()
    _, procs, d = start_ranks("fail", 2, tmp_path, {"timeout_s": 30})
    codes = wait_all(procs, timeout=60)
    assert codes[0] != 0 and codes[1] != 0, codes
    with open(os.path.join(d, "log_1.txt")) as f:
        assert "rank 1 fails" in f.read()
    assert time.monotonic() - t0 < 60
