"""The plumbing of ``chip_smoke.py``'s phase 12 (f) (the MoE beside a data
axis) that runs without a card: ``--phase-12 f`` runs that case alone, with
one card it says so and returns nothing, its launches join the kernels
line's ``mp`` path by world size, ``MOE_ROUTE_GATE`` passes a routing with
one card's capacity and drops and fails one with a rank's own capacity or
drops off by more than ``MOE_DROP_TOL`` of its pairs, and ``--phase-12 f``
and ``--moe-rank`` without a card exit non-zero before printing a result
line.
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chip_smoke

REPO = Path(__file__).resolve().parent.parent
CASES = {"a": "_tp_shard_kernels", "b": "_moe_check", "c": "_tp_multi", "d": "_mp_multi",
         "e": "_tp_zero_multi", "f": "_moe_data_multi"}


def test_phase12_f_runs_that_case_alone(monkeypatch):
    ran = []
    for letter, fn in CASES.items():
        monkeypatch.setattr(chip_smoke, fn,
                            lambda *a, letter=letter: ran.append(letter) or {letter: 1})
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    out = chip_smoke.mp_phase("card", None, "f")
    assert ran == ["f"]
    assert out["moe_data"] == {"f": 1} and out["moe"] == {} and out["tpz"] == {}
    ran.clear()
    chip_smoke.mp_phase("card", None)
    assert ran == list("abcdef")


def test_phase12_f_on_one_card_says_so(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert chip_smoke._moe_data_multi("card", None) == {}
    assert "one card: the MoE beside a data axis needs two" in capsys.readouterr().out


def test_phase12_f_launches_join_the_mp_path():
    zeros = {"attention_qkv": 0}
    mp = {"moe": {"train": zeros, "eval": zeros}, "tp": {}, "mp": {}, "tpz": {},
          "moe_data": {2: {"train": {"attention_qkv": 12}, "eval": {"attention_qkv": 12}},
                       4: {"train": {"attention_qkv": 12}, "eval": {"attention_qkv": 12}}}}
    got = chip_smoke._mp_launches(mp, "attention_qkv")
    assert got == {"moe_train": 0, "moe_eval": 0, "moe_data2_train": 12, "moe_data2_eval": 12,
                   "moe_data4_train": 12, "moe_data4_eval": 12}
    mp["moe_data"] = {}
    assert set(chip_smoke._mp_launches(mp, "attention_qkv")) == {"moe_train", "moe_eval"}


def _routing(capacity, drops):
    return {"capacity": capacity, "drops": torch.tensor(drops)}


@pytest.mark.parametrize("case, ok", [("same", True), ("own_capacity", False),
                                      ("drops_off", False), ("features_off", False)])
def test_moe_route_gate(case, ok):
    B, n_tok = chip_smoke.B_EVAL, 4
    gen = torch.Generator().manual_seed(0)
    feats = torch.randn(B, 8, generator=gen)
    ref_drops = [1 if t % 3 == 0 else 0 for t in range(B * n_tok)]
    ref = _routing(100, ref_drops)
    rows = slice(B // 2, B)
    mine = ref_drops[B // 2 * n_tok:]
    run = {"same": _routing(100, mine), "own_capacity": _routing(50, mine),
           "drops_off": _routing(100, [1] * len(mine)), "features_off": _routing(100, mine)}[case]
    got = feats.clone()
    if case == "features_off":
        got[0] = -got[0]
    gate = chip_smoke._route_gate(run, ref, rows, feats, got)
    assert gate["ok"] is ok
    assert gate["pairs"] == 2 * (B // 2) * n_tok and gate["ref_drops"] == sum(mine)


@pytest.mark.parametrize("argv", [["--phase-12", "f"], ["--moe-rank", "."]])
def test_phase12_f_without_a_card_exits_before_the_result_line(tmp_path, argv):
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), *argv],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                               "PYTHONPATH": str(REPO)})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    if argv[0] == "--phase-12":
        assert "no CUDA device" in proc.stdout + proc.stderr
