"""A tiny cell of each driver, for the CPU tests: the configuration files'
structure at widths and sizes a test run can hold."""

from __future__ import annotations

import copy
import json
from pathlib import Path

from benchmark.harness import Cell

ROOT = Path(__file__).resolve().parent.parent

TINY_MODEL = {"img_size": [64, 32], "embed_dim": 96, "depth": 2, "num_heads": 4,
              "mlp_ratio": 2.0}
TINY_LOAD = {"MODEL.TRANSFORMER_TYPE": "vit_tiny_test", "INPUT.SIZE_TRAIN": "[64, 32]",
             "INPUT.SIZE_TEST": "[64, 32]", "INPUT.PADDING": "4", "SOLVER.IMS_PER_BATCH": "8",
             "DATALOADER.NUM_INSTANCE": "4", "TEST.IMS_PER_BATCH": "8"}
TINY_TRAFFIC = {"train": {"ids": 8, "items": 40, "ids_per_batch": 2, "instances": 4,
                          "plan_steps": 40, "trace_units": 2},
                "eval": {"query": 12, "gallery": 12, "ids": 4, "cameras": 2, "batch": 8,
                         "reference_rows": 8, "trace_units": 1}}


def tiny_cell(name: str) -> Cell:
    """The cell ``name`` of the benchmark cut to the tiny sizes."""
    w = json.loads((ROOT / "workloads" / f"{name}.json").read_text())
    cfg = json.loads((ROOT / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((ROOT / "traffic" / f"{w['traffic']}.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg["num_classes"], cfg["camera_num"] = 8, 3
    cfg["model"].update(TINY_MODEL)
    cfg["input"]["padding"] = 4
    load = dict(zip(cfg["load_config"][0::2], cfg["load_config"][1::2]), **TINY_LOAD)
    cfg["load_config"] = [x for kv in load.items() for x in kv]
    traffic = dict(traffic, **TINY_TRAFFIC[traffic["driver"]])
    return Cell(name=name, config=cfg, traffic=traffic, chips=1, limits=dict(w["limits"]))
