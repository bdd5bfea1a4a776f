"""The plumbing of ``chip_smoke.py``'s phase 17 (the one-process settings,
the checkpoint converter and the measuring tools) that runs without a card:
the cases ``tools_phase`` runs are the letters it is given (a case not run
counts 0 launches), ``--phase-17 [cases]`` without a card exits non-zero
before any result line, and the kernels line of the full run carries a
``tools`` path whose train step and eval forward are summed into each
kernel's totals as the other paths' are (every other phase stubbed).
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chip_smoke

REPO = Path(__file__).resolve().parent.parent
NAMES = list(chip_smoke.KERNELS) + list(chip_smoke.VARIANTS)


def test_tools_phase_runs_only_the_cases_named(monkeypatch):
    ran = []
    monkeypatch.setattr(chip_smoke, "_p17_settings",
                        lambda card, ms: ran.append(("a", card, ms)) or {"train": 1})
    monkeypatch.setattr(chip_smoke, "_p17_convert", lambda gen: ran.append("b") or {"eval": 2})
    monkeypatch.setattr(chip_smoke, "_p17_tools",
                        lambda: ran.append("c") or {"launches": {"bench": 3}})
    zero = chip_smoke.expected()
    out = chip_smoke.tools_phase("card", None, 139.9, "")
    assert ran == [] and out == {"train": zero, "eval": zero, "bench": zero}
    out = chip_smoke.tools_phase("card", None, None, "bc")
    assert ran == ["b", "c"] and out == {"train": zero, "eval": {"eval": 2}, "bench": {"bench": 3}}
    ran.clear()
    out = chip_smoke.tools_phase("card", None, 139.9)
    assert ran == [("a", "card", 139.9), "b", "c"] and out["train"] == {"train": 1}


@pytest.mark.parametrize("args", [["--phase-17"], ["--phase-17", "bc"]])
def test_phase17_without_a_card_exits_before_the_result_line(tmp_path, args):
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), *args],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                               "PYTHONPATH": str(REPO)})
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stdout + proc.stderr
    assert '"ok": true' not in proc.stdout


def test_kernels_line_sums_the_tools_path(monkeypatch, capsys):
    """Every phase stubbed with 0 launches but phase 17's (1 a train step,
    2 an eval forward, 5 in the tools' run): each row's totals are 1 and 2
    and its ``tools`` path holds the three."""
    zero = {n: 0 for n in NAMES}
    both = {"train": zero, "eval": zero}
    stubs = {
        "card_check": lambda: "card", "build_phase": lambda: None,
        "kernel_phase": lambda gen: {n: {"ms": 1.0} for n in chip_smoke.KERNELS},
        "variant_phase": lambda gen: {n: {"ms": 1.0} for n in chip_smoke.VARIANTS},
        "forward_phase": lambda gen: (None, zero), "serving_phase": lambda *a: None,
        "train_phase": lambda gen: (zero, 140.0), "uncompacted_phase": lambda gen: (zero, zero),
        "loop_phase": lambda card, ms: dict(both, run=zero),
        "serve_phase": lambda card: {"query": zero, "visualize": zero},
        "dp_phase": lambda card, ms: both, "fsdp_phase": lambda card: both,
        "mp_phase": lambda card, gen: {"moe": both, "tp": None, "mp": None, "tpz": {},
                                       "moe_data": {}, "shard": {}},
        "pp_phase": lambda card, gen, ms: dict(both, multi={}),
        "config_phase": lambda gen: {"train": {"launches": zero}, "eval": {"launches": zero},
                                     "remat": {}, "dropout": both, "kernels": {}},
        "library_phase": lambda card, gen: {"losses": {"forward": zero, "backward": zero},
                                            "profiling": {"eval": zero}},
        "zoo_phase": lambda card: {},
        "tools_phase": lambda card, gen, ms: {"train": {n: 1 for n in NAMES},
                                              "eval": {n: 2 for n in NAMES},
                                              "bench": {n: 5 for n in NAMES}},
    }
    for name, fn in stubs.items():
        monkeypatch.setattr(chip_smoke, name, fn)
    generator = torch.Generator
    monkeypatch.setattr(torch, "Generator", lambda device=None: generator())
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: "card")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    chip_smoke.main()
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(lines[-1]) == {"ok": True, "device": {"platform": "gpu", "kind": "card",
                                                            "count": 1}}
    rows = json.loads(lines[-2])["kernels"]
    assert [r["name"] for r in rows] == NAMES
    for r in rows:
        assert r["launches"] == 1 and r["launches_eval"] == 2, r["name"]
        assert r["launches_by_path"]["tools"] == {"train": 1, "eval": 2, "bench": 5}
