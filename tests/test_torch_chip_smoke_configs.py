"""The plumbing of ``chip_smoke.py``'s phase 14 (the model configurations)
that runs without a card: the overrides each case passes reach the model
config through ``load_config`` -> ``editor_config_from`` (stride 12: 21 x
10 patches, N = 211, the tail of 87; the remat policies; dropout and
attention dropout), the step comparison's reading (bit for bit, relative
differences floored at 1e-3 of the largest change), and ``--phase-14``
without a card exits non-zero before printing a result line.
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chip_smoke

REPO = Path(__file__).resolve().parent.parent


def test_stride12_reaches_the_model_config():
    from editor_tpu_torch.models.editor import _tail_keep_count

    cfg, ecfg = chip_smoke.flagship(chip_smoke.STRIDE12)
    assert ecfg.vit.stride_size == (12, 12)
    assert (ecfg.vit.num_y, ecfg.vit.num_x) == (21, 10)
    assert ecfg.num_patches + 1 == chip_smoke.N_STRIDE12
    assert _tail_keep_count(ecfg, 3) == 87
    assert cfg.SOLVER.IMS_PER_BATCH == 128


@pytest.mark.parametrize("policy", ["block", "dots", "names", "attn_out"])
def test_remat_and_dropout_options_reach_the_model_config(policy):
    _, ecfg = chip_smoke.flagship(["TPU.REMAT", "True", "TPU.REMAT_POLICY", policy,
                                   "TPU.REMAT_SKIP_LAST", "4", "MODEL.ATT_DROP_RATE", "0.1",
                                   "MODEL.DROP_OUT", "0.1"])
    vit = ecfg.vit
    assert (vit.remat, vit.remat_policy, vit.remat_skip_last) == (True, policy, 4)
    assert (vit.attn_drop_rate, vit.drop_rate) == (0.1, 0.1)


def test_step_diff_reads_bit_for_bit_and_relative_changes():
    ref = {"loss": 2.0, "delta": [torch.ones(4), torch.full((3,), 1e-9)]}
    same = {"loss": 2.0, "delta": [t.clone() for t in ref["delta"]]}
    d = chip_smoke._step_diff(same, ref)
    assert d == {"rel_dloss": 0.0, "rel_dparam": 0.0, "bit_for_bit": True}
    # a tiny tensor's change is held to the floor (1e-3 of the largest norm)
    off = {"loss": 2.002, "delta": [torch.ones(4), torch.full((3,), 2e-9)]}
    d = chip_smoke._step_diff(off, ref)
    assert not d["bit_for_bit"]
    assert d["rel_dloss"] == pytest.approx(1e-3)
    assert d["rel_dparam"] == pytest.approx((3 * 1e-18) ** 0.5 / 2e-3)
    big = {"loss": 2.0, "delta": [torch.full((4,), 1.01), torch.full((3,), 1e-9)]}
    assert chip_smoke._step_diff(big, ref)["rel_dparam"] == pytest.approx(0.01, rel=1e-4)


def test_phase14_without_a_card_exits_before_the_result_line(tmp_path):
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), "--phase-14", "e"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                               "PYTHONPATH": str(REPO)})
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stdout + proc.stderr
    assert '"ok": true' not in proc.stdout
