"""The port imports neither JAX nor the JAX package, and its kernel wrappers
import without nvcc or triton (they build and load the CUDA library only
when handed a CUDA tensor)."""

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
from editor_tpu_torch.tools import profile_forward

vit = vit_tiny_test_config(img_size=(64, 32), patch_size=16, stride_size=(16, 16), camera=4)
cfg = EditorConfig(num_classes=10, vit=vit, head_keep=2, frequency_keep=3)
step = build_eval_step(editor_init(cfg, seed=0), torch.float32)
gen = torch.Generator().manual_seed(0)
batch = {m: torch.randn(2, 64, 32, 3, generator=gen) for m in ("RGB", "NI", "TI")}
batch["camid"] = torch.tensor([0, 3])
feats = step(batch)
new = sorted(set(sys.modules) - before)
print(json.dumps({"shape": list(feats.shape), "finite": bool(torch.isfinite(feats).all()),
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
    assert out["shape"] == [2, 288] and out["finite"]
    bad = [m for m in out["new"] if m.split(".")[0] in ("jax", "jaxlib", "editor_tpu", "triton")]
    assert not bad, bad
    # the build module (ctypes + nvcc) stays unloaded on the CPU path
    assert "editor_tpu_torch.ops._build" not in out["new"]
    assert out["launches"] == [0, 0, 0]
