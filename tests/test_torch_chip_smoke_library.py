"""The plumbing of ``chip_smoke.py``'s phase 15 (the library surface) that
runs without a card: the cases ``library_phase`` runs are the letters it is
given (none: nothing runs), ``--phase-15 [cases]`` without a card exits
non-zero before any result line, the analytic count printed beside
``cost_analysis`` is ``bench.py::model_tflop_per_image`` exactly, the RPC
processes' functions send by reference (module level) and compute what
they should on CPU tensors, and the relative error reads the reference's
scale.
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chip_smoke

REPO = Path(__file__).resolve().parent.parent


def test_library_phase_runs_only_the_cases_named(monkeypatch):
    ran = []
    for name in ("_p15_dtcwt", "_p15_losses", "_p15_profiling", "_p15_sharded", "_p15_rpc"):
        monkeypatch.setattr(chip_smoke, name,
                            lambda *a, _n=name: ran.append(_n) or {"case": _n})
    gen = torch.Generator()
    assert chip_smoke.library_phase("card", gen, "") == {} and ran == []
    out = chip_smoke.library_phase("card", gen, "be")
    assert ran == ["_p15_losses", "_p15_rpc"] and set(out) == {"losses", "rpc"}
    ran.clear()
    assert set(chip_smoke.library_phase("card", gen)) == {"dtcwt", "losses", "profiling",
                                                          "sharded", "rpc"}


@pytest.mark.parametrize("args", [["--phase-15"], ["--phase-15", "ae"]])
def test_phase15_without_a_card_exits_before_the_result_line(tmp_path, args):
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), *args],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                               "PYTHONPATH": str(REPO)})
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stdout + proc.stderr
    assert '"ok": true' not in proc.stdout


def test_analytic_count_is_bench_py_s():
    import bench
    from __graft_entry__ import _flagship_cfg

    from tests.torch_parity import torch_editor_config

    for use_pallas in (True, False):
        jcfg = _flagship_cfg(use_pallas=use_pallas)
        got = chip_smoke._bench_tflop_per_image(torch_editor_config(jcfg))
        assert got == pytest.approx(bench.model_tflop_per_image(jcfg), rel=1e-12)
    _, ecfg = chip_smoke.flagship()
    assert 0.05 < chip_smoke._bench_tflop_per_image(ecfg) < 0.2  # ~0.08 TFLOP an image


def test_rpc_functions_are_sent_by_reference_and_compute_on_cpu():
    from editor_tpu_torch.parallel.rpc import _by_reference

    for fn in (chip_smoke._rpc_weight, chip_smoke._rpc_linear, chip_smoke._rpc_decay,
               chip_smoke._rpc_square, chip_smoke._rpc_counter):
        assert _by_reference(fn, "chip_smoke") is fn
    w = torch.randn(chip_smoke.RPC_IN, chip_smoke.RPC_OUT, generator=torch.Generator()
                    .manual_seed(7))
    x = torch.randn(4, chip_smoke.RPC_IN)
    out = chip_smoke._rpc_linear(w, x)
    assert out["device"] == "cpu" and torch.equal(out["y"], x @ w)
    assert torch.equal(chip_smoke._rpc_decay(w, 0.5), w * 0.5)


def test_relative_error_reads_the_reference_scale():
    ref = torch.tensor([[4.0, -2.0], [0.0, 1.0]])
    assert chip_smoke._rel_err(ref + 0.04, ref) == pytest.approx(0.01)
    assert chip_smoke._rel_err(ref.double(), ref) == 0.0
