"""The port imports neither JAX nor the JAX package (nor yaml or PIL, which
the card's machine is not promised), and its kernel wrappers import without
nvcc or triton (they build and load the CUDA library only when handed a CUDA
tensor): a tiny eval forward, a tiny train step, a tiny training loop (with
its evaluation, log and checkpoints) and the parameter count run in a
subprocess that imports every module of the port's entry points (the
launcher ``cli.launch`` among them) and of its data parallelism
(``parallel/``, FSDP, LocalSGD and the launcher's supervisor, rendezvous and
etcd modules included: importing it needs no NCCL and makes no process
group) and of its model parallelism (``parallel/{tp,moe,ring}``; a tiny MoE
model's forward, with ``moe_shards`` too, and train step run there), and
the library surface off the model path (``parallel/{rpc,sharded_tensor}``,
``ops/dtcwt``, the auxiliary losses, ``utils/{profiling,debug}``; the tiny
forward's ``cost_analysis`` and a scattering layer run there) and the CNN
zoo (``models/{cnn_zoo,zoo/*}``, ``utils/zoo_import``; a SqueezeNet forward
and ``cli.params --cnn`` run there), and a static
scan of every import statement of the port and of chip_smoke.py (which
imports the port inside its functions) finds neither package, nor
``cloudpickle``."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

_PROBE = r"""
import json, sys
before = set(sys.modules)
import torch
import editor_tpu_torch
from editor_tpu_torch import ops
from editor_tpu_torch.ops import fused_attention, fused_linear, masked_attention, rollout
from editor_tpu_torch.models.editor import (EditorConfig, editor_config_from,
                                            vit_tiny_test_config)
from editor_tpu_torch.models.init import editor_init
from editor_tpu_torch.engine.evaluate import build_eval_step
from editor_tpu_torch.tools import (profile_forward, profile_train, bench_attn, bench_attn2,
                                    bench_attn_layer, bench_full_kernel, bench_rollout,
                                    bench_rollout2, kernel_digest, kernel_sass)
from editor_tpu_torch.config import Config, load_config
from editor_tpu_torch.data.transforms import make_train_augment
from editor_tpu_torch.engine.train import build_train_step
from editor_tpu_torch.losses import make_loss
from editor_tpu_torch.models import ocfr
from editor_tpu_torch.solver import make_optimizer, make_scheduler
from editor_tpu_torch.cli import params as cli_params, test as cli_test, train as cli_train
from editor_tpu_torch.data import datasets, loader, sampler
from editor_tpu_torch.engine import loop
from editor_tpu_torch.engine.evaluate import do_inference
from editor_tpu_torch.evals import metrics, reranking
from editor_tpu_torch.utils import checkpoint, logger, meter, torch_convert
from editor_tpu_torch import native
from editor_tpu_torch.cli import export as cli_export, serve as cli_serve
from editor_tpu_torch.cli import visualize as cli_visualize
from editor_tpu_torch.evals import reranking_device
from editor_tpu_torch.serve import RetrievalServer
from editor_tpu_torch.utils import jax_weights, visualize
from editor_tpu_torch import parallel
from editor_tpu_torch.parallel import collectives, compression, ddp, mesh, multihost, zero
from editor_tpu_torch.parallel import elastic, etcd, fsdp, localsgd, rendezvous
from editor_tpu_torch.cli import launch as cli_launch
from editor_tpu_torch.parallel import moe, ring, tp
from editor_tpu_torch.parallel import deferred_bn, pipeline, pipeline_vit
# the library surface off the model path
from editor_tpu_torch.parallel import rpc, sharded_tensor
from editor_tpu_torch.ops import dtcwt
from editor_tpu_torch.losses import center, extra
from editor_tpu_torch.utils import debug, profiling
from editor_tpu_torch.solver.schedule import add_lr_noise
from editor_tpu_torch.data.sampler import CyclingIterator, IdentitySampler
from editor_tpu_torch.data.transforms import random_grayscale_patch
# the CNN zoo
from editor_tpu_torch.models import cnn_zoo, zoo
from editor_tpu_torch.models.zoo import (common, densenet, inception, light, nasnet, osnet,
                                         reid_special, resnet, senet, xception)
from editor_tpu_torch.utils import zoo_import
import torch.distributed as dist
group_after_import = dist.is_initialized()  # importing the data-parallel modules makes no group

vit = vit_tiny_test_config(img_size=(64, 32), patch_size=16, stride_size=(16, 16), camera=4)
cfg = EditorConfig(num_classes=10, vit=vit, head_keep=2, frequency_keep=3)
step = build_eval_step(editor_init(cfg, seed=0, device="cpu"), torch.float32)
gen = torch.Generator().manual_seed(0)
batch = {m: torch.randn(2, 64, 32, 3, generator=gen) for m in ("RGB", "NI", "TI")}
batch["camid"] = torch.tensor([0, 3])
feats = step(batch)
model = editor_init(cfg, seed=1, device="cpu")
tcfg = Config()
train = build_train_step(model, make_optimizer(tcfg, model), make_loss(tcfg, 10),
                         make_scheduler(tcfg), 0.001, torch.float32,
                         augment=make_train_augment(tcfg.INPUT))
u8 = {m: torch.randint(0, 256, (4, 64, 32, 3), generator=gen, dtype=torch.uint8)
      for m in ("RGB", "NI", "TI")}
u8["pid"], u8["camid"] = torch.tensor([0, 0, 1, 1]), torch.tensor([0, 1, 2, 3])
loss = float(train(u8, 1)["loss"])
# the MoE joint MLP: eval (one routing, and two emulated shards) and a train step
import dataclasses
mcfg = dataclasses.replace(cfg, moe_experts=4)
mmodel = editor_init(mcfg, seed=2, device="cpu")
with torch.no_grad():
    moe_feats = [mmodel({k: v for k, v in batch.items() if k != "camid"}, batch["camid"],
                        moe_shards=s) for s in (1, 2)]
mtrain = build_train_step(mmodel, make_optimizer(tcfg, mmodel), make_loss(tcfg, 10),
                          make_scheduler(tcfg), 0.001, torch.float32)
moe_loss = float(mtrain({k: v.float() if v.dtype == torch.uint8 else v
                         for k, v in u8.items()}, 1)["loss"])
# the training loop on in-memory splits through a numpy decode_fn, with its
# log, metrics and checkpoints: no PIL, no yaml
import tempfile
import numpy as np
items = [(i, i // 4, i % 2, -1) for i in range(16)]
splits = datasets.DatasetSplits(items, items[:8:4], items, 4, 2)
decode = lambda it: [np.full((64, 32, 3), 10 * it[1], np.uint8)] * 3
lcfg = load_config(None, ["MODEL.TRANSFORMER_TYPE", "vit_tiny_test", "MODEL.PRETRAIN_CHOICE",
                          "random", "INPUT.SIZE_TRAIN", "[64, 32]", "INPUT.SIZE_TEST", "[64, 32]",
                          "MODEL.FREQUENCY_KEEP", "3", "DATALOADER.NUM_INSTANCE", "2",
                          "SOLVER.IMS_PER_BATCH", "4", "SOLVER.MAX_EPOCHS", "1",
                          "TPU.COMPUTE_DTYPE", "float32", "OUTPUT_DIR", tempfile.mkdtemp()])
best = loop.do_train(lcfg, dm=loader.ReIDDataModule(lcfg, splits=splits, decode_fn=decode),
                     max_steps_per_epoch=2, device="cpu")["best"]
n_params = cli_params.main(["MODEL.TRANSFORMER_TYPE", "vit_tiny_test"])
# the eval forward's operations, through the kernel wrappers' own counts
flops = profiling.cost_analysis(step, batch)["flops"]
scat = list(dtcwt.scat_layer_j2(torch.randn(1, 16, 16, 2, generator=gen)).shape)
with torch.no_grad():
    zoo_logits = list(zoo.build_model("squeezenet1_1", 5, device="cpu")(
        torch.randn(2, 3, 64, 64, generator=gen)).shape)
zoo_count = cli_params.main(["--cnn", "resnet18", "--num_classes", "100"])
new = sorted(set(sys.modules) - before)
print(json.dumps({"shape": list(feats.shape), "finite": bool(torch.isfinite(feats).all()),
                  "loss_finite": loss == loss and abs(loss) < float("inf"),
                  "moe": [list(f.shape) for f in moe_feats]
                  + [bool(all(torch.isfinite(f).all() for f in moe_feats)),
                     moe_loss == moe_loss and abs(moe_loss) < float("inf")],
                  "loop_map": best["mAP"], "n_params": n_params,
                  "new": new, "group": group_after_import or dist.is_initialized(),
                  "parallel": sorted(parallel.__all__),
                  "launches": [fn.launches for fn in ops.KERNEL_WRAPPERS],
                  "flops": flops, "scat": scat, "zoo": [zoo_logits, zoo_count]}))
"""


def test_port_imports_no_jax_and_runs_tiny_forward(tmp_path):
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME=str(tmp_path / "no-cuda"),
               PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["shape"] == [2, 288] and out["finite"] and out["loss_finite"]
    assert 0.0 < out["loop_map"] <= 1.0 and out["n_params"] > 0
    bad = [m for m in out["new"] if m.split(".")[0] in ("jax", "jaxlib", "editor_tpu", "triton",
                                                        "yaml", "PIL", "tensorboard",
                                                        "cloudpickle")]
    assert not bad, bad
    # the build module (ctypes + nvcc) stays unloaded on the CPU path
    assert "editor_tpu_torch.ops._build" not in out["new"]
    assert out["launches"] == [0] * 8
    # the data-parallel modules import without NCCL (a CPU-only torch has
    # none) and make no process group (the loop above ran on one device)
    assert out["group"] is False
    assert {"make_mesh", "build_ddp_train_step", "make_reducer", "zero1_state_shardings",
            "all_gather", "reduce_scatter", "send_recv"} <= set(out["parallel"])
    # FSDP, the rendezvous stores and backends, etcd (what the JAX package's
    # parallel/__init__ exports of the ported modules)
    assert {"fsdp_shardings", "param_memory_bytes", "shard_params", "DynamicRendezvous",
            "FileStore", "TCPStore", "RendezvousHandlerRegistry", "rendezvous_registry",
            "monitored_barrier", "all_gather_object", "broadcast_object", "EtcdServer",
            "EtcdStore"} <= set(out["parallel"])
    # model parallelism: tensor parallelism, the MoE, ring and Ulysses
    assert {"shard_editor", "shard_state_dict", "permute_qkv_params", "qkv_tp_permutation",
            "moe_ffn", "moe_ffn_dense", "moe_init", "MoEParams", "ring_attention",
            "ring_masked_attention", "ulysses_attention",
            "ulysses_masked_attention"} <= set(out["parallel"])
    # the pipeline: the GPipe schedule, skips, balance, the EDITOR backbone, DeferredBN
    assert {"pipeline_apply", "pipeline_train_step", "init_skips", "stash", "pop",
            "balance_stages", "profile_layer_costs", "make_pipeline_backbone",
            "make_stage_fn", "PipelineBackbone", "bn_params_init", "bn_acc_init",
            "deferred_bn_apply", "deferred_bn_commit"} <= set(out["parallel"])
    assert out["moe"] == [[2, 288], [2, 288], True, True]
    for name in ("fsdp", "localsgd", "elastic", "rendezvous", "etcd", "tp", "moe", "ring",
                 "pipeline", "pipeline_vit", "deferred_bn"):
        assert f"editor_tpu_torch.parallel.{name}" in out["new"], name
    assert "editor_tpu_torch.cli.launch" in out["new"]
    # the library surface: rpc on torch.distributed.rpc (no cloudpickle),
    # sharded tensors, the DTCWT, the auxiliary losses, profiling and debug
    for name in ("parallel.rpc", "parallel.sharded_tensor", "ops.dtcwt", "losses.center",
                 "losses.extra", "utils.debug", "utils.profiling"):
        assert f"editor_tpu_torch.{name}" in out["new"], name
    assert out["flops"] > 0 and out["scat"] == [1, 4, 4, 98]
    # the CNN zoo: every family, the facade, the importer, cli.params --cnn
    for name in ("models.cnn_zoo", "models.zoo", "models.zoo.common", "models.zoo.densenet",
                 "models.zoo.inception", "models.zoo.light", "models.zoo.nasnet",
                 "models.zoo.osnet", "models.zoo.reid_special", "models.zoo.resnet",
                 "models.zoo.senet", "models.zoo.xception", "utils.zoo_import"):
        assert f"editor_tpu_torch.{name}" in out["new"], name
    assert out["zoo"] == [[2, 5], 11227812]


def _imported_roots(path: Path) -> set:
    """The top-level package of every import statement in a file, wherever
    the statement stands (module level or inside a function)."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_file_of_the_port_imports_jax_statically():
    """Nor ``cloudpickle``, which the card's machine lacks (the port's RPC
    sends functions by reference)."""
    files = sorted((REPO / "editor_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 30
    for name in ("parallel/rpc.py", "parallel/sharded_tensor.py", "ops/dtcwt.py",
                 "losses/center.py", "losses/extra.py", "utils/debug.py", "utils/profiling.py",
                 "models/cnn_zoo.py", "models/zoo/__init__.py", "models/zoo/reid_special.py",
                 "utils/zoo_import.py"):
        assert REPO / "editor_tpu_torch" / name in files, name
    bad = {str(f.relative_to(REPO)): sorted(_imported_roots(f) & {"jax", "jaxlib", "editor_tpu",
                                                                 "cloudpickle"})
           for f in files}
    assert not {f: r for f, r in bad.items() if r}


_FAKE_NVCC = """#!/bin/sh
# records its arguments; writes the -o target; fails on a source named bad.cu
echo "$@" >> "$NVCC_LOG"
for a in "$@"; do case "$a" in *bad.cu) echo "bad.cu(1): error" >&2; exit 2;; esac; done
out=""; prev=""
for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
echo built > "$out"
"""


def _fake_toolkit(tmp_path, monkeypatch, sources):
    from editor_tpu_torch.ops import _build

    csrc, cuda = tmp_path / "csrc", tmp_path / "cuda"
    csrc.mkdir()
    (cuda / "bin").mkdir(parents=True)
    nvcc = cuda / "bin" / "nvcc"
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    for name in sources:
        (csrc / name).write_text(f"// {name}\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("CUDA_HOME", str(cuda))
    monkeypatch.setenv("NVCC_LOG", str(tmp_path / "nvcc.log"))
    return _build, tmp_path / "nvcc.log"


def test_build_compiles_each_source_then_links(tmp_path, monkeypatch):
    """One ``nvcc -c`` per source (started together), then one link into a
    library named by the sources' hash; a second build reuses it."""
    _build, log = _fake_toolkit(tmp_path, monkeypatch, ["a.cu", "b.cu", "common.cuh"])
    lib = _build.build()
    assert lib == _build.library_path() and lib.read_text() == "built\n"
    calls = log.read_text().splitlines()
    compiles = [c for c in calls if " -c " in f" {c} "]
    assert len(calls) == 3 and len(compiles) == 2
    assert all("arch=compute_90a,code=sm_90a" in c for c in calls)
    assert "-shared" in calls[-1] and calls[-1].count(".o") == 2
    assert _build.build() == lib and len(log.read_text().splitlines()) == 3
    # an edited header is a new library
    (_build.CSRC / "common.cuh").write_text("// edited\n")
    assert _build.library_path() != lib


def test_build_reports_every_failed_source(tmp_path, monkeypatch):
    _build, log = _fake_toolkit(tmp_path, monkeypatch, ["good.cu", "bad.cu"])
    with pytest.raises(RuntimeError, match=r"bad\.cu\(1\): error"):
        _build.build()
    assert not _build.library_path().exists()
    assert not any("-shared" in c for c in log.read_text().splitlines())  # no link
