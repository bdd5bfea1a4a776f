"""The benchmark's files: BENCHMARK.json, the cells, configurations,
traffic mixes, drivers and metric readers name each other consistently,
and each configuration file states the program's configuration."""

import json
import re
from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark.reference.editor import Shape, param_shapes

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_agree(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    w = json.loads((ROOT / "workloads" / f"{cell}.json").read_text())
    assert (w["config"], w["traffic"], w["chips"]) == (entry["config"], entry["traffic"],
                                                       entry["chips"])
    c = harness.load_cell(cell)
    assert (ROOT / "drivers" / f"{c.traffic['driver']}.py").exists()
    assert hasattr(c.driver, "drive")
    conf = next(x for x in BENCH["configs"] if x["name"] == w["config"])
    assert conf["file"] == f"benchmark/configs/{w['config']}.json"
    assert conf["reduced"] == c.config["reduced"]


def test_metric_readers_match_benchmark_json():
    readers = harness.metric_readers()
    assert set(readers) == {m["name"] for m in BENCH["per_layer"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert readers[m["name"]].UNIT == m["unit"] and m["moves"] in e2e
        for cell in m["workloads"]:
            kind = harness.load_cell(cell).traffic["driver"]
            assert m["name"].endswith("." + kind)


@pytest.mark.parametrize("cell", CELLS)
def test_config_states_the_programs_configuration(cell):
    from editor_tpu_torch.models.editor import Editor, editor_config_from

    from benchmark import program
    c = harness.load_cell(cell)
    pcfg = program.config(c.config)
    e = editor_config_from(pcfg, c.config["num_classes"], c.config["camera_num"])
    m, s = c.config["model"], Shape(c.config)
    assert (list(e.vit.img_size), e.vit.patch_size, list(e.vit.stride_size)) == (
        m["img_size"], m["patch_size"], m["stride_size"])
    assert (e.vit.embed_dim, e.vit.depth, e.vit.num_heads, e.vit.mlp_ratio) == (
        m["embed_dim"], m["depth"], m["num_heads"], m["mlp_ratio"])
    assert (e.head_keep, e.frequency_keep, e.al, e.vit.drop_path_rate, e.vit.sie_xishu) == (
        m["head_keep"], m["frequency_keep"], m["al"], m["drop_path_rate"], m["sie_xishu"])
    sol, inp, tf = c.config["solver"], c.config["input"], c.traffic
    assert (pcfg.SOLVER.BASE_LR, pcfg.SOLVER.MOMENTUM, pcfg.SOLVER.WEIGHT_DECAY,
            pcfg.SOLVER.WEIGHT_DECAY_BIAS, pcfg.SOLVER.BIAS_LR_FACTOR,
            pcfg.SOLVER.WARMUP_ITERS, pcfg.SOLVER.MAX_EPOCHS) == (
        sol["base_lr"], sol["momentum"], sol["weight_decay"], sol["weight_decay_bias"],
        sol["bias_lr_factor"], sol["warmup_iters"], sol["max_epochs"])
    assert (pcfg.INPUT.PROB, pcfg.INPUT.RE_PROB, pcfg.INPUT.PADDING,
            list(pcfg.INPUT.PIXEL_MEAN), list(pcfg.INPUT.PIXEL_STD)) == (
        inp["prob"], inp["re_prob"], inp["padding"], inp["pixel_mean"], inp["pixel_std"])
    if tf["driver"] == "train":
        assert tf["ids_per_batch"] * tf["instances"] == pcfg.SOLVER.IMS_PER_BATCH
        assert tf["instances"] == pcfg.DATALOADER.NUM_INSTANCE
    else:
        assert tf["batch"] == pcfg.TEST.IMS_PER_BATCH
    model = Editor(e, device="meta")
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == param_shapes(s)


def test_a_run_loads_no_module_of_jax_or_the_jax_package():
    # a whole tiny run on the CPU in a fresh process, the reference's
    # judgement with it; names are compared by their whole top-level part
    import subprocess
    import sys
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark import faults, harness, run\n"
            "from benchmark.tests.tiny import tiny_cell\n"
            "for c in ('rgbnt201.train', 'rgbnt201_s12.eval'):\n"
            "    harness.run_cell(tiny_cell(c), 5, 0.2, True, 'cpu', 0.0, log=lambda s: None)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n" % str(ROOT.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT.parent)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "editor_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "editor_tpu"}
