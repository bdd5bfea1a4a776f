"""The plumbing of ``chip_smoke.py``'s phase 16 (the CNN zoo) that runs
without a card: the cases ``zoo_phase`` runs are the letters it is given
(none: nothing runs), over every ``MODEL_FACTORY`` entry in the factory's
order; ``--phase-16 [cases]`` without a card exits non-zero before any
result line; the size tables (case (a)'s sizes are the CPU tests'; in case
(b) the entries with a fixed or a minimum size but HACNN take 256x128,
HACNN only its 160x64 and MuDeep only 256x128, run on the meta device; the
other entries' 256x128 runs in the chip run); the scaled BN statistics
keep SE-ResNet-101 well conditioned (fp32 within 1e-5 of f64 at 64x32,
where the unscaled draws gave 7.1e-5 on the card; one torch thread) and are
drawn from the generator alone; the renaming keeps each module's leaves
together.
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chip_smoke
from editor_tpu_torch.models.zoo import MODEL_FACTORY, build_empty, build_model
from editor_tpu_torch.models.zoo.common import BatchNorm
from tests.torch_zoo import HW, one_thread

REPO = Path(__file__).resolve().parent.parent


def test_zoo_phase_runs_only_the_cases_named_over_every_entry(monkeypatch):
    ran = []
    monkeypatch.setattr(chip_smoke, "_zoo_entry",
                        lambda name, gen, cases: ran.append(("entry", name, cases)) or {})
    monkeypatch.setattr(chip_smoke, "_zoo_import",
                        lambda name, entry: ran.append(("import", name)) or {})
    monkeypatch.setattr(chip_smoke, "_zoo_count", lambda: ran.append(("count",)) or {})
    assert chip_smoke.zoo_phase("card", "") == {} and ran == []
    assert set(chip_smoke.zoo_phase("card", "d")) == {"count"} and ran == [("count",)]
    ran.clear()
    out = chip_smoke.zoo_phase("card", "c")
    assert [r[1] for r in ran if r[0] == "entry"] == list(MODEL_FACTORY)
    assert [r[1] for r in ran if r[0] == "import"] == list(chip_smoke.ZOO_IMPORT)
    assert set(out) == {"entries", "import"} and list(out["entries"]) == list(MODEL_FACTORY)
    ran.clear()
    assert set(chip_smoke.zoo_phase("card")) == {"entries", "import", "count"}
    assert {r[2] for r in ran if r[0] == "entry"} == {"abcd"}


@pytest.mark.parametrize("args", [["--phase-16"], ["--phase-16", "bd"]])
def test_phase16_without_a_card_exits_before_the_result_line(tmp_path, args):
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), *args],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                               "PYTHONPATH": str(REPO)})
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stdout + proc.stderr
    assert '"ok": true' not in proc.stdout


def test_size_tables():
    assert chip_smoke.ZOO_SMALL_HW == HW and chip_smoke.ZOO_HW == (256, 128)
    assert chip_smoke.ZOO_IMPORT == ("resnet50", "cal")
    for name in list(HW) + ["resnet18"]:
        h, w = chip_smoke.zoo_full_hw(name)
        assert (h, w) == chip_smoke.ZOO_FULL_HW.get(name, chip_smoke.ZOO_HW)
        out = build_empty(name, 5)(torch.empty(1, 3, h, w, device="meta"))
        assert out.shape[0] == 1 and out.shape[-1] in (5, 10), name
    with pytest.raises(ValueError, match="160x64"):
        build_empty("hacnn", 5)(torch.empty(1, 3, 256, 128, device="meta"))
    with pytest.raises(RuntimeError):
        build_empty("mudeep", 5)(torch.empty(1, 3, 160, 64, device="meta"))


def _scaled(name, seed=16):
    gen = torch.Generator().manual_seed(seed)
    m = build_model(name, 11, device="cpu")
    chip_smoke._random_bn_stats(m, torch.randn(8, 3, 64, 32, generator=gen), gen)
    return m, gen


def test_scaled_bn_statistics_keep_se_resnet101_well_conditioned():
    with one_thread():
        m, gen = _scaled("se_resnet101")
        bns = [b for b in m.modules() if isinstance(b, BatchNorm)]
        assert all(not torch.all(b.running_var == 1) for b in bns)
        a, b = _scaled("resnet18")[0].state_dict(), _scaled("resnet18")[0].state_dict()
        assert all(torch.equal(v, b[k]) for k, v in a.items())
        x = torch.randn(2, 3, 64, 32, generator=gen)
        with torch.no_grad():
            y = m(x).double()
            ref = m.double()(x.double())
    assert float((y - ref).abs().max() / ref.abs().max()) <= 1e-5


def test_renamed_keeps_each_module_s_leaves_together():
    state = build_empty("cal", 3).state_dict()
    renamed = chip_smoke._renamed(state)
    assert [k.rpartition(".")[2] for k in renamed] == [k.rpartition(".")[2] for k in state]
    assert len({k.rpartition(".")[0] for k in renamed}) == len(
        {k.rpartition(".")[0] for k in state})
    assert chip_smoke._row_cosine(torch.tensor([[1.0, 0.0], [0.0, 2.0]]),
                                  torch.tensor([[1.0, 1.0], [0.0, 1.0]])) == pytest.approx(
        2 ** -0.5)
