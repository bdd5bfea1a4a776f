"""The port imports neither JAX nor the JAX package (nor yaml, which the
card's machine is not promised), and its kernel wrappers import without nvcc
or triton (they build and load the CUDA library only when handed a CUDA
tensor): a tiny eval forward and a tiny train step run in a subprocess, and
a static scan of every import statement of the port and of chip_smoke.py
(which imports the port inside its functions) finds neither package."""

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
    assert out["launches"] == [0] * 8


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
    files = sorted((REPO / "editor_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 30
    bad = {str(f.relative_to(REPO)): sorted(_imported_roots(f) & {"jax", "jaxlib", "editor_tpu"})
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
