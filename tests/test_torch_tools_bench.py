"""The port's twins of the JAX tools' measuring scripts
(``editor_tpu_torch/tools/bench_{stages,train,bwd,loader}.py``) without a
card: each tool's cases run at the tiny config (depth 2, width 96, 64 x 32
images) on the kernels' plain versions, with ``_bench.cuda_ms`` replaced by
one call of the timed function (so the numbers are placeholders and only the
plumbing is checked: every case runs its work once and prints one line in
its format); a case that raises prints ``FAIL`` and its error and is listed,
the others still run, and ``_bench.finish`` then exits non-zero; each
``main`` exits non-zero without CUDA. ``bench_loader`` really runs here on a
small tree (16 ids x 8: one batch of 128 an epoch): every decode path this
machine has.
``models.editor.flagship_config`` (the tools' model) is
``__graft_entry__._flagship_cfg`` (the JAX tools'). One torch thread.
"""

import re

import numpy as np
import pytest
import torch

from editor_tpu_torch.config import load_config
from editor_tpu_torch.models.editor import editor_config_from, flagship_config
from editor_tpu_torch.tools import _bench, bench_bwd, bench_loader, bench_stages, bench_train

TOOLS = (bench_stages, bench_train, bench_bwd, bench_loader)
NUM = r"-?\d+\.\d{4} ms"


@pytest.fixture
def plumbing(monkeypatch):
    """One torch thread; ``cuda_ms`` runs the function once and returns a
    count of its calls, so each timed case is done and has a number."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    calls = []

    def once(fn, iters=20, warmup=3):
        fn()
        calls.append(fn)
        return float(len(calls))

    monkeypatch.setattr(_bench, "cuda_ms", once)
    yield calls
    torch.set_num_threads(threads)


def tiny(num_classes=16):
    cfg = load_config(None, ["MODEL.TRANSFORMER_TYPE", "vit_tiny_test", "INPUT.SIZE_TRAIN",
                             "[64, 32]", "INPUT.SIZE_TEST", "[64, 32]",
                             "MODEL.FREQUENCY_KEEP", "3"])
    return editor_config_from(cfg, num_classes, 2)


def _lines(capsys):
    return [ln for ln in capsys.readouterr().out.splitlines() if ln]


def test_bench_stages_runs_each_stage(plumbing, capsys):
    t, failed = bench_stages.run(B=2, iters=1, ecfg=tiny(), device="cpu")
    lines = _lines(capsys)
    assert failed == [] and len(plumbing) == 5
    assert lines[0] == "B=2 images=3x64x32 bf16 device=cpu"
    labels = ["full eval", "backbone (no roll)", "backbone + rollout", "frequency",
              "sfts+fusion tail", "unaccounted"]
    assert [ln.split(":")[0] for ln in lines[1:]] == labels
    assert all(re.search(NUM, ln) for ln in lines[1:])
    assert "img_per_s=" in lines[1] and "rollout_ms=" in lines[3]
    assert t["unaccounted"] == t["full"] - t["backbone_rollout"] - t["frequency"] - t["tail"]


def test_backbone_without_rollout_is_the_forwards_tokens():
    torch.manual_seed(0)
    from editor_tpu_torch.models.init import editor_init
    ecfg = tiny()
    vit = editor_init(ecfg, seed=0, device="cpu").BACKBONE.base
    x, cams = torch.randn(3, 64, 32, 3), torch.tensor([0, 1, 0])
    with torch.inference_mode():
        assert torch.equal(bench_stages.backbone_tokens(vit, x, cams, True),
                           vit(x, cams, None, True)[0])


def test_bench_stages_failure_is_reported_and_the_rest_runs(plumbing, capsys, monkeypatch):
    from editor_tpu_torch.models import frequency
    monkeypatch.setattr(frequency, "frequency_token_select",
                        lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom")))
    t, failed = bench_stages.run(B=2, iters=1, ecfg=tiny(), device="cpu")
    out = capsys.readouterr().out
    assert failed == ["frequency", "sfts+fusion tail", "unaccounted"]
    assert "frequency: FAIL RuntimeError: boom" in out and t["backbone"] is not None
    with pytest.raises(SystemExit) as e:
        _bench.finish("bench_stages", failed)
    assert e.value.code and "3 case(s) failed" in str(e.value.code)
    _bench.finish("bench_stages", [])  # no failure: returns


def test_bench_train_sweeps_the_skip_values(plumbing, capsys, monkeypatch):
    from editor_tpu_torch.engine import train
    seen = []
    build = train.build_train_step

    def spy(model, *a, **k):
        seen.append(model.cfg.vit)
        return build(model, *a, **k)

    monkeypatch.setattr(train, "build_train_step", spy)
    out, failed = bench_train.run(skips=(0, 2), B=32, iters=1, ecfg=tiny(), device="cpu")
    lines = _lines(capsys)
    assert failed == [] and lines[0] == "B=32 remat=block images bf16 device=cpu"
    assert [(v.remat, v.remat_policy, v.remat_skip_last) for v in seen] == [
        (True, "block", 0), (True, "block", 2)]
    for ln, skip in zip(lines[1:], (0, 2)):
        assert ln.startswith(f"skip_last={skip}:") and re.search(NUM, ln)
        assert "img_per_s=" in ln and "peak_gb=not measured  before_gb=not measured" in ln
    assert set(out) == {0, 2}


def test_bench_bwd_lines_carry_bound_sdpa_and_the_fixed_group(plumbing, capsys):
    out, failed = bench_bwd.run(B=2, N=17, C=32, H=2, hw=(64, 32), iters=1, device="cpu")
    lines = _lines(capsys)
    assert failed == [] and len(lines) == 5
    assert [ln.split(":")[0] for ln in lines[1:]] == [
        "frequency", "attention_qkv_bwd [6, 17, 96]", "masked_attention_tiled_bwd [6, 17]",
        "masked_attention_tiled_bwd [2, 51]"]
    for ln in lines[2:]:
        assert re.search(r"bound=\d+\.\d{4} ms \((bytes|operations)\)", ln)
        assert "sdpa_bwd_ms=" in ln and ln.endswith("group=fixed")


def test_bwd_bound_counts_the_valid_pairs():
    qkv, g = torch.zeros(384, 129, 2304), torch.zeros(384, 129, 768)
    ms, by = bench_bwd.bwd_bound(qkv, g, 12)  # K4 at the backbone: PERF.md's 0.159 ms
    assert by == "bytes" and ms == pytest.approx(2.0 * 384 * 129 * 5376 / 3.35e12 * 1e3)
    mask = torch.zeros(2, 129)
    mask[:, :10] = 1.0
    flops = 10.0 * 12 * 64 * 2 * 100
    assert bench_bwd.bwd_bound(qkv[:2], g[:2], 12, mask)[0] == pytest.approx(max(
        flops / 989e12, (2.0 * 2 * 129 * 5376 + 4.0 * 2 * 129) / 3.35e12) * 1e3)


def test_bench_loader_runs_each_path_on_a_tiny_tree(tmp_path, capsys):
    import importlib.util

    from editor_tpu_torch.native import load_imagecodec
    out, failed = bench_loader.run(ids=16, workers=2, repeats=1, root=str(tmp_path))
    lines = _lines(capsys)
    assert failed == [] and lines[0].startswith("tree: 16 ids x 8 x 3 modalities 256x128")
    pil = importlib.util.find_spec("PIL") is not None
    ran = {"native codec": pil and load_imagecodec() is not None, "PIL pool": pil,
           "decode_fn (np.load)": True}
    for ln, (label, can) in zip(lines[1:], ran.items()):
        assert ln.startswith(label + ": ")
        if can:
            assert re.search(r"best +\d+\.\d samples/s \( *\d+\.\d decodes/s\)", ln), ln
            assert out[label] > 0
        else:
            assert "not run" in ln and out[label] is None
    raw = np.load(tmp_path / "raw" / "NI" / "000015_cam4_7.npy")
    assert raw.shape == (256, 128, 3) and raw.dtype == np.uint8


def test_bench_loader_without_pil_runs_the_decode_fn_alone(tmp_path, capsys, monkeypatch):
    import importlib.util
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "PIL" else real(name, *a))
    out, failed = bench_loader.run(ids=16, workers=2, repeats=1, root=str(tmp_path))
    lines = _lines(capsys)
    assert failed == [] and "raw .npy only (no PIL: no JPEG encoder)" in lines[0]
    assert lines[1] == "native codec: not run: no JPEG tree without PIL"
    assert lines[2] == "PIL pool: not run: PIL is not present"
    assert out["decode_fn (np.load)"] > 0
    assert not list((tmp_path / "RGBNT201" / "train_171" / "RGB").iterdir())


@pytest.mark.parametrize("tool", TOOLS, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_main_exits_non_zero_without_cuda(tool, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        tool.main([])
    assert "no CUDA device" in str(e.value.code)
    assert capsys.readouterr().out == ""


def test_flagship_config_is_the_jax_tools_flagship():
    from __graft_entry__ import _flagship_cfg

    from tests.torch_parity import torch_editor_config
    assert flagship_config() == torch_editor_config(_flagship_cfg())


def test_the_new_modules_import_no_jax_pil_yaml_or_triton(tmp_path):
    """The tools and the converter on the port's import chain: importing
    them (and the loop with its one-rank group) loads none of the packages
    the card's machine lacks or the port must not use."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    probe = ("import json, sys; before = set(sys.modules)\n"
             "from editor_tpu_torch.tools import (bench_bwd, bench_loader, bench_stages,\n"
             "    bench_train, convert_checkpoint)\n"
             "from editor_tpu_torch.engine import loop\n"
             "print(json.dumps(sorted(set(sys.modules) - before)))\n")
    repo = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(repo)})
    assert proc.returncode == 0, proc.stderr
    new = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "editor_tpu_torch.tools.convert_checkpoint" in new
    assert not [m for m in new if m.split(".")[0] in ("jax", "jaxlib", "editor_tpu", "triton",
                                                      "yaml", "PIL")]
