"""Tensor parallelism (``TPU.MESH_MODEL`` > 1) around the step, on the CPU
at float64 (``tests/test_torch_tp.py`` holds the step against JAX's; the
same gloo ranks and JAX oracles):

* The TP eval features at data 2 x model 2 against JAX's ``build_eval_step``
  on the TP mesh (rtol 1e-9, atol 1e-12: the same f64 sums in another
  order); ``FeatureExtractor(mesh=)`` against a one-device extractor of the
  full model (1e-12).
* A canonical checkpoint written after step 1 at tp = 2 (SGD and AdamW)
  equals the gathered model; resumed at tp = 2 it gives step 2 of the
  uninterrupted run bit for bit, and at tp = 1 (one process, no mesh)
  within 1e-12.
* ``cli.train`` with ``TPU.MESH_MODEL 2`` on two and four gloo ranks
  (launched as torchrun would) against one process and against two
  data-parallel ranks: the same logged losses (rtol 1e-5: float32 sums in
  another order); ``cli.test`` in one process on the TP run's checkpoint
  gives the mAP the run logged (1e-6); a second launch resumes at tp = 2.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editor_tpu.engine.evaluate import build_eval_step as jax_build_eval_step
from editor_tpu.parallel import tp as jax_tp_mod
from editor_tpu.parallel.mesh import make_mesh as jax_make_mesh
from editor_tpu.parallel.mesh import shard_batch as jax_shard_batch
from tests.torch_dp import finish, start_ranks
from tests.torch_dp_jax import jax_setup, make_batch, port_inputs
from tests.torch_parity import x64  # noqa: F401


def test_tp_eval_features_match_jax(x64, tmp_path):
    jcfg, _, _, state = jax_setup()
    batch = make_batch()
    rng = np.random.RandomState(5)
    request = {m: rng.randint(0, 256, (6, 64, 32, 3)).astype(np.uint8)
               for m in ("RGB", "NI", "TI")}
    inp = dict(port_inputs(jcfg, state, batch), tp=2, request=request)
    launch = start_ranks("tp_eval", 4, tmp_path, inp)
    H = jcfg.vit.num_heads
    mesh = jax_make_mesh(data=2, model=2, devices=jax.devices()[:4])
    st = jax_tp_mod.permute_train_state(state, H, 2)
    st = jax.tree_util.tree_map(jax.device_put, st,
                                jax_tp_mod.train_state_tp_shardings(st, mesh))
    feed = jax_shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items() if k != "pid"})
    ref = np.asarray(jax_build_eval_step(jcfg, jnp.float64, mesh)(st.params, st.model_state,
                                                                   feed))
    got = finish(launch, timeout=120)
    for r in range(4):
        np.testing.assert_allclose(got[r]["feats"].numpy(), ref, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(got[r]["served"], got[r]["served_ref"], rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("optimizer", ["SGD", "AdamW"])
def test_tp_checkpoint_is_canonical_and_resumes_at_any_tp(x64, optimizer, tmp_path):
    jcfg, _, _, state = jax_setup()
    inp = dict(port_inputs(jcfg, state, make_batch()), optimizer=optimizer)
    ckpt = str(tmp_path / "tp_step1.pt")
    got = finish(start_ranks("train", 2, tmp_path / "tp2", dict(inp, runs=[
        {"kind": "global", "tp": 2},
        {"kind": "global", "tp": 2, "steps": 1, "save_after": 1, "save_path": ckpt},
        {"kind": "global", "tp": 2, "steps": 1, "resume": ckpt}])), timeout=120)
    whole, first, resumed = got[0]
    payload = torch.load(ckpt, weights_only=False)
    # canonical: the model of a one-device run, the slots of its shape
    assert all(torch.equal(payload["model"][k], first["sd"][k]) for k in inp["sd"])
    for k, v in payload["model"].items():
        assert v.shape == inp["sd"][k].shape, k
    assert resumed["loss"] == whole["loss"][1:]
    assert all(torch.equal(resumed["sd"][k], whole["sd"][k]) for k in inp["sd"])
    one = finish(start_ranks("train", 1, tmp_path / "tp1", dict(inp, runs=[
        {"kind": "single", "steps": 1, "resume": ckpt}])), timeout=120)[0][0]
    np.testing.assert_allclose(one["loss"], whole["loss"][1:], rtol=1e-12)
    for k, v in whole["sd"].items():
        if v.is_floating_point():
            np.testing.assert_allclose(one["sd"][k].numpy(), v.numpy(), rtol=1e-12,
                                       atol=1e-12, err_msg=k)


TINY = ["MODEL.TRANSFORMER_TYPE", "vit_tiny_test", "INPUT.SIZE_TRAIN", "[64, 32]",
        "INPUT.SIZE_TEST", "[64, 32]", "MODEL.STRIDE_SIZE", "[16, 16]",
        "MODEL.FREQUENCY_KEEP", "3", "DATALOADER.NUM_INSTANCE", "2",
        "DATALOADER.NUM_WORKERS", "2", "SOLVER.IMS_PER_BATCH", "8", "SOLVER.LOG_PERIOD", "1",
        "TEST.IMS_PER_BATCH", "5", "TPU.COMPUTE_DTYPE", "float32"]


def _cli(tmp_path, name, world, out, epochs, opts=()):
    argv = (["--device", "cpu"] + TINY + list(opts)
            + ["SOLVER.MAX_EPOCHS", str(epochs), "OUTPUT_DIR", out])
    return start_ranks("cli_train", world, tmp_path / name, {"argv": argv}, launcher=True)


def _losses(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r["loss"] for r in recs if "loss" in r], [r["mAP"] for r in recs if "mAP" in r]


def test_cli_train_tensor_parallel_on_two_and_four_ranks(tmp_path):
    """``TPU.MESH_MODEL 2``: at W = 2 (data 1) the ranks draw what one
    process draws, at W = 4 (data 2) what two data-parallel ranks draw."""
    from editor_tpu_torch.cli import test as cli_test
    from editor_tpu_torch.data.datasets import DatasetSplits
    from tests.torch_dp import decode, items

    out = {n: str(tmp_path / n / "run") for n in ("tp2", "one", "tp4", "dp2")}
    tp_opt = ["TPU.MESH_MODEL", "2"]
    launches = [_cli(tmp_path, "tp2", 2, out["tp2"], 1, tp_opt),
                _cli(tmp_path, "one", 1, out["one"], 1),
                _cli(tmp_path, "tp4", 4, out["tp4"], 1, tp_opt),
                _cli(tmp_path, "dp2", 2, out["dp2"], 1)]
    ranks = [finish(launch, timeout=150) for launch in launches]
    assert ranks[0][1]["opened"] == [] and ranks[2][3]["opened"] == []
    # the two ranks of a model group load the same host shard
    assert [r["loads"][0]["host_id"] for r in ranks[2]] == [0, 0, 1, 1]
    for a, b in (("tp2", "one"), ("tp4", "dp2")):
        la, ma = _losses(out[a])
        lb, mb = _losses(out[b])
        assert len(la) == len(lb) > 0
        np.testing.assert_allclose(la, lb, rtol=1e-5, err_msg=a)
    # the TP run's canonical checkpoint in one process: the mAP it logged
    train, query, gallery = items()
    _, mAP = cli_test.main(["--device", "cpu"] + TINY + [
        "OUTPUT_DIR", "", "TEST.WEIGHT", os.path.join(out["tp2"], "ckpt")],
        splits=DatasetSplits(train, query, gallery, 4, 2), decode_fn=decode)
    assert abs(mAP - _losses(out["tp2"])[1][-1]) <= 1e-6
    # a second TP launch resumes and trains the second epoch
    finish(_cli(tmp_path, "tp2b", 2, out["tp2"], 2, tp_opt), timeout=150)
    with open(os.path.join(out["tp2"], "train_log.txt")) as f:
        log = f.read()
    assert "Resumed from checkpoint step 2 (epoch 1)" in log and "TP: backbone" in log
    assert np.isfinite(_losses(out["tp2"])[0]).all()
