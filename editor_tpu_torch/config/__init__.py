"""Typed configuration: the port's copy of ``editor_tpu/config/__init__.py``.

Dataclasses with the same sections, keys and defaults (reference:
config/defaults.py), a YAML merge and dotted-key ``SECTION.KEY value``
overrides, so the repo's presets (``configs/*.yaml``) load unchanged. The
``TPU`` section keeps its name so that presets and overrides transfer; on the
GPU its ``COMPUTE_DTYPE``, ``GRAD_ACCUM``, ``REMAT*`` and ``COMPACT_TAIL``
knobs mean what they say, the mesh knobs above one device raise in the
training loop and the checkpoint knobs are unused. ``yaml`` is imported only
where a file is read (``dump`` writes JSON, which is YAML), since the card's
machine is not promised it.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

__all__ = [
    "ModelConfig",
    "InputConfig",
    "DatasetsConfig",
    "DataloaderConfig",
    "SolverConfig",
    "TestConfig",
    "TPUConfig",
    "Config",
    "RGBNT201_PRESET",
    "load_config",
]

# The solver, input, sampler and selection settings of configs/RGBNT201.yaml
# as ``load_config`` overrides (the card's machine is not promised yaml),
# with AL left off as the flagship bench's train step runs it:
# ``editor_config_from(load_config(None, RGBNT201_PRESET), 171, 6)`` is the
# flagship model.
RGBNT201_PRESET = ["SOLVER.OPTIMIZER_NAME", "SGD", "SOLVER.BASE_LR", "0.001",
                   "SOLVER.WARMUP_ITERS", "10", "SOLVER.IMS_PER_BATCH", "128",
                   "SOLVER.MAX_EPOCHS", "70", "INPUT.PROB", "0.5", "INPUT.RE_PROB", "0.5",
                   "INPUT.PADDING", "10", "DATALOADER.NUM_INSTANCE", "16",
                   "MODEL.HEAD_KEEP", "2", "MODEL.FREQUENCY_KEEP", "10"]


@dataclass
class ModelConfig:
    # reference: config/defaults.py:7-56
    DEVICE: str = "tpu"
    DEVICE_ID: str = "0"
    NAME: str = "EDITOR"
    MARGIN: float = 0.0
    PRETRAIN_PATH_T: str = ""
    PRETRAIN_CHOICE: str = "imagenet"  # 'imagenet' | 'self' | 'random'
    MIX_DIM: int = 768
    NECK: str = "bnneck"
    IF_WITH_CENTER: str = "no"
    ID_LOSS_TYPE: str = "softmax"
    ID_LOSS_WEIGHT: float = 1.0
    TRIPLET_LOSS_WEIGHT: float = 1.0
    METRIC_LOSS_TYPE: str = "triplet"
    DIST_TRAIN: bool = False
    IF_LABELSMOOTH: str = "on"
    AL: int = 0
    HEAD_KEEP: int = 1
    FREQUENCY_KEEP: int = 10
    DROP_PATH: float = 0.1
    DROP_OUT: float = 0.0
    ATT_DROP_RATE: float = 0.0
    TRANSFORMER_TYPE: str = "vit_base_patch16_224"
    STRIDE_SIZE: Tuple[int, int] = (16, 16)
    SIE_COE: float = 3.0
    SIE_CAMERA: bool = True
    SIE_VIEW: bool = False
    NO_MARGIN: bool = True
    # >0: fusion block's joint MLP becomes a GShard MoE with this many
    # experts (beyond-reference expert-parallel variant; models/fusion.py)
    MOE_EXPERTS: int = 0
    MOE_AUX_WEIGHT: float = 0.01


@dataclass
class InputConfig:
    # reference: config/defaults.py:60-74
    SIZE_TRAIN: Tuple[int, int] = (256, 128)
    SIZE_TEST: Tuple[int, int] = (256, 128)
    PROB: float = 0.5  # random horizontal flip
    RE_PROB: float = 0.5  # random erasing
    PIXEL_MEAN: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    PIXEL_STD: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    PADDING: int = 10


@dataclass
class DatasetsConfig:
    # reference: config/defaults.py:79-83
    NAMES: str = "RGBNT201"
    ROOT_DIR: str = "./data"


@dataclass
class DataloaderConfig:
    # reference: config/defaults.py:87-93
    NUM_WORKERS: int = 4
    SAMPLER: str = "softmax_triplet"
    NUM_INSTANCE: int = 16
    # native (C++/libjpeg, OpenMP) batch decode+resize fast path: measured
    # faster than the PIL pool per core (identity-crop 2110 vs 1692 img/s)
    # and scales with OpenMP threads on many-core hosts; matches PIL bicubic
    # within ~3 u8 LSB (tests/test_native.py). Auto-falls back to the PIL
    # thread pool when g++/libjpeg are unavailable.
    NATIVE_DECODE: bool = True


@dataclass
class SolverConfig:
    # reference: config/defaults.py:98-152
    OPTIMIZER_NAME: str = "SGD"
    MAX_EPOCHS: int = 70
    BASE_LR: float = 0.001
    LARGE_FC_LR: bool = False
    BIAS_LR_FACTOR: float = 2.0
    MOMENTUM: float = 0.9
    MARGIN: float = 0.3
    CLUSTER_MARGIN: float = 0.3
    CENTER_LR: float = 0.5
    CENTER_LOSS_WEIGHT: float = 0.0005
    RANGE_K: int = 2
    RANGE_MARGIN: float = 0.3
    RANGE_ALPHA: float = 0.0
    RANGE_BETA: float = 1.0
    RANGE_LOSS_WEIGHT: float = 1.0
    WEIGHT_DECAY: float = 0.0001
    WEIGHT_DECAY_BIAS: float = 0.0001
    GAMMA: float = 0.1
    WARMUP_FACTOR: float = 0.01
    WARMUP_ITERS: int = 10
    WARMUP_METHOD: str = "linear"
    COSINE_MARGIN: float = 0.5
    COSINE_SCALE: float = 30.0
    SEED: int = 1111
    CHECKPOINT_PERIOD: int = 60
    LOG_PERIOD: int = 10
    EVAL_PERIOD: int = 1
    KL: float = 0.0
    IMS_PER_BATCH: int = 128


@dataclass
class TestConfig:
    # reference: config/defaults.py:159-169
    IMS_PER_BATCH: int = 64
    RE_RANKING: str = "no"
    WEIGHT: str = ""
    NECK_FEAT: str = "before"
    FEAT_NORM: str = "yes"


@dataclass
class TPUConfig:
    """Knobs of the JAX package with no reference counterpart (the name is
    kept so that presets and overrides transfer)."""

    COMPUTE_DTYPE: str = "bfloat16"  # compute dtype under jit; params stay fp32
    MESH_DATA: int = -1  # data-parallel mesh axis size; -1 = all local devices
    MESH_MODEL: int = 1  # model-parallel mesh axis size (TP hooks)
    # 0 = replicated opt state, 1 = ZeRO-1 (opt state sharded over data
    # axis), 3 = FSDP/ZeRO-3 (params + opt state sharded; parallel/fsdp.py)
    ZERO_STAGE: int = 0
    # microbatches accumulated per optimizer step inside the jitted step
    # (engine/train.py) — IMS_PER_BATCH must be divisible by it
    GRAD_ACCUM: int = 1
    REMAT: bool = False  # jax.checkpoint the backbone blocks
    # 'block' (fastest measured) | 'dots' | 'names' | 'attn_out'
    REMAT_POLICY: str = "block"
    REMAT_SKIP_LAST: int = 0  # last k backbone layers skip remat (HBM for speed)
    # run the fusion tail on the (static-bound) selected-token subset only —
    # mathematically exact, ~30% less tail work (models/editor.py)
    COMPACT_TAIL: bool = True
    ASYNC_CHECKPOINT: bool = True
    GRAD_COMPRESSION: str = "none"  # 'none' | 'fp16' | 'bf16' | 'powersgd'
    POWERSGD_RANK: int = 4
    DONATE: bool = True
    # also mirror metrics into TensorBoard event files under OUTPUT_DIR/tb
    # (the reference's SummaryWriter, engine/processor.py:42, minus the
    # hardcoded path); JSONL remains the primary stream
    TENSORBOARD: bool = False


@dataclass
class Config:
    MODEL: ModelConfig = field(default_factory=ModelConfig)
    INPUT: InputConfig = field(default_factory=InputConfig)
    DATASETS: DatasetsConfig = field(default_factory=DatasetsConfig)
    DATALOADER: DataloaderConfig = field(default_factory=DataloaderConfig)
    SOLVER: SolverConfig = field(default_factory=SolverConfig)
    TEST: TestConfig = field(default_factory=TestConfig)
    TPU: TPUConfig = field(default_factory=TPUConfig)
    OUTPUT_DIR: str = "./outputs"

    # ---- derived helpers -------------------------------------------------
    @property
    def num_patches(self) -> int:
        # reference: modeling/make_model.py:90-91
        h, w = self.INPUT.SIZE_TRAIN
        sh, sw = self.MODEL.STRIDE_SIZE
        return (h // sh) * (w // sw)

    @property
    def head_keep_ratio(self) -> float:
        # reference: modeling/make_model.py:92-93
        return (1.0 / self.num_patches) * int(self.MODEL.HEAD_KEEP)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def dump(self) -> str:
        """The config as a YAML document in JSON form (YAML 1.2 is a superset
        of JSON): ``load_config`` and any YAML reader take it, and writing it
        needs no yaml module, which the card's machine is not promised."""
        return json.dumps(self.to_dict(), indent=2) + "\n"


# ---------------------------------------------------------------------------
# loading / merging
# ---------------------------------------------------------------------------

def _coerce(value: Any, target: Any) -> Any:
    """Coerce *value* (possibly a string from CLI) to the type of *target*."""
    if isinstance(target, bool):
        if isinstance(value, str):
            return value.strip().lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(target, int) and not isinstance(target, bool):
        return int(value)
    if isinstance(target, float):
        return float(value)
    if isinstance(target, tuple):
        if isinstance(value, str):
            value = json.loads(value.replace("(", "[").replace(")", "]"))
        return tuple(value)
    if isinstance(target, str):
        if isinstance(value, str):
            # the reference YAMLs wrap some strings in ('...') tuples syntax
            return value.strip("()'\" ")
        return str(value)
    return value


def _merge_into(obj: Any, updates: dict, path: str = "") -> None:
    for key, val in updates.items():
        if not hasattr(obj, key):
            raise KeyError(f"Unknown config key: {path}{key}")
        cur = getattr(obj, key)
        if dataclasses.is_dataclass(cur) and isinstance(val, dict):
            _merge_into(cur, val, path=f"{path}{key}.")
        else:
            object.__setattr__(obj, key, _coerce(val, cur))


def _set_dotted(cfg: Config, dotted_key: str, value: Any) -> None:
    parts = dotted_key.split(".")
    obj: Any = cfg
    for part in parts[:-1]:
        if not hasattr(obj, part):
            raise KeyError(f"Unknown config section: {dotted_key}")
        obj = getattr(obj, part)
    leaf = parts[-1]
    if not hasattr(obj, leaf):
        raise KeyError(f"Unknown config key: {dotted_key}")
    object.__setattr__(obj, leaf, _coerce(value, getattr(obj, leaf)))


def load_config(
    yaml_path: Optional[str] = None,
    overrides: Optional[List[Any]] = None,
) -> Config:
    """Build a Config from defaults, an optional YAML file, and CLI overrides.

    ``overrides`` is a flat ``[KEY, VALUE, KEY, VALUE, ...]`` list with dotted
    keys (``SOLVER.BASE_LR 0.01``), matching the reference CLI contract
    (reference: train_net.py:28-40).
    """
    cfg = Config()
    if yaml_path:
        import yaml

        with open(yaml_path) as f:
            data = yaml.safe_load(f) or {}
        _merge_into(cfg, data)
    if overrides:
        if len(overrides) % 2 != 0:
            raise ValueError("overrides must be KEY VALUE pairs")
        for k, v in zip(overrides[0::2], overrides[1::2]):
            _set_dotted(cfg, str(k), v)
    return cfg
