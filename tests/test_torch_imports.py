"""The port imports neither JAX nor the JAX package (nor yaml, which the
card's machine is not promised), and its kernel wrappers import without nvcc
or triton (they build and load the CUDA library only when handed a CUDA
tensor): a tiny eval forward and a tiny train step run in a subprocess."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_PROBE = r"""
import json, sys
before = set(sys.modules)
import torch
import editor_tpu_torch
from editor_tpu_torch import ops
from editor_tpu_torch.ops import fused_attention, masked_attention, rollout
from editor_tpu_torch.models.editor import EditorConfig, vit_tiny_test_config
from editor_tpu_torch.models.init import editor_init
from editor_tpu_torch.engine.evaluate import build_eval_step
from editor_tpu_torch.tools import profile_forward, profile_train
from editor_tpu_torch.config import Config, load_config
from editor_tpu_torch.data.transforms import make_train_augment
from editor_tpu_torch.engine.train import build_train_step
from editor_tpu_torch.losses import make_loss
from editor_tpu_torch.models import ocfr
from editor_tpu_torch.solver import make_optimizer, make_scheduler

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
new = sorted(set(sys.modules) - before)
print(json.dumps({"shape": list(feats.shape), "finite": bool(torch.isfinite(feats).all()),
                  "loss_finite": loss == loss and abs(loss) < float("inf"),
                  "new": new,
                  "launches": [fn.launches for fn in ops.KERNEL_WRAPPERS]}))
"""


def test_port_imports_no_jax_and_runs_tiny_forward(tmp_path):
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME=str(tmp_path / "no-cuda"),
               PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["shape"] == [2, 288] and out["finite"] and out["loss_finite"]
    bad = [m for m in out["new"]
           if m.split(".")[0] in ("jax", "jaxlib", "editor_tpu", "triton", "yaml")]
    assert not bad, bad
    # the build module (ctypes + nvcc) stays unloaded on the CPU path
    assert "editor_tpu_torch.ops._build" not in out["new"]
    assert out["launches"] == [0] * 5
