"""CNN backbone zoo: the 50 entries of the reference's factory across 22
architecture families (``editor_tpu/models/zoo/__init__.py``; reference:
modeling/backbones/basic_cnn_params/__init__.py:25-96, ``__model_factory``
and ``build_model``), inference only.

``build_model(name, num_classes)`` returns an ``nn.Module`` in eval mode
whose ``forward`` takes NCHW images ``[B, 3, H, W]`` and returns what JAX's
``apply`` returns on the NHWC images: logits ``[B, nc]``, ``[B, 2 nc]`` for
HACNN (global | local), ``[B, parts, nc]`` for PCB. JAX's ``build_model``
returns ``(params, apply)``; ``utils/zoo_import.state_dict_from_jax_zoo``
maps those params onto the module.
"""

from __future__ import annotations

import torch
from torch import nn

from editor_tpu_torch.models.editor import default_device
from editor_tpu_torch.models.zoo import densenet as _dense
from editor_tpu_torch.models.zoo import inception as _inc
from editor_tpu_torch.models.zoo import light as _light
from editor_tpu_torch.models.zoo import nasnet as _nas
from editor_tpu_torch.models.zoo import osnet as _os
from editor_tpu_torch.models.zoo import reid_special as _reid
from editor_tpu_torch.models.zoo import resnet as _res
from editor_tpu_torch.models.zoo import senet as _se
from editor_tpu_torch.models.zoo import xception as _xc
from editor_tpu_torch.models.zoo.common import count_params, init_weights

# name -> fn(num_classes) -> nn.Module; the reference's __model_factory,
# its 'nasnsetmobile' typo included
MODEL_FACTORY = {
    # image classification models
    "cal": _reid.cal,
    "resnet18": _res.resnet18,
    "resnet34": _res.resnet34,
    "resnet50": _res.resnet50,
    "resnet101": _res.resnet101,
    "resnet152": _res.resnet152,
    "resnext50_32x4d": _res.resnext50_32x4d,
    "resnext101_32x8d": _res.resnext101_32x8d,
    "resnet50_fc512": _res.resnet50_fc512,
    "se_resnet50": _se.se_resnet50,
    "se_resnet50_fc512": _se.se_resnet50_fc512,
    "se_resnet101": _se.se_resnet101,
    "se_resnext50_32x4d": _se.se_resnext50_32x4d,
    "se_resnext101_32x4d": _se.se_resnext101_32x4d,
    "densenet121": _dense.densenet121,
    "densenet169": _dense.densenet169,
    "densenet201": _dense.densenet201,
    "densenet161": _dense.densenet161,
    "densenet121_fc512": _dense.densenet121_fc512,
    "inceptionresnetv2": _inc.inceptionresnetv2,
    "inceptionv4": _inc.inceptionv4,
    "xception": _xc.xception,
    "resnet50_ibn_a": _res.resnet50_ibn_a,
    "resnet50_ibn_b": _res.resnet50_ibn_b,
    # lightweight models
    "nasnsetmobile": _nas.nasnetamobile,
    "mobilenetv2_x1_0": _light.mobilenetv2_x1_0,
    "mobilenetv2_x1_4": _light.mobilenetv2_x1_4,
    "shufflenet": _light.shufflenet,
    "squeezenet1_0": _light.squeezenet1_0,
    "squeezenet1_0_fc512": _light.squeezenet1_0_fc512,
    "squeezenet1_1": _light.squeezenet1_1,
    "shufflenet_v2_x0_5": _light.shufflenet_v2_x0_5,
    "shufflenet_v2_x1_0": _light.shufflenet_v2_x1_0,
    "shufflenet_v2_x1_5": _light.shufflenet_v2_x1_5,
    "shufflenet_v2_x2_0": _light.shufflenet_v2_x2_0,
    # reid-specific models
    "mudeep": _reid.mudeep,
    "resnet50mid": _res.resnet50mid,
    "hacnn": _reid.hacnn,
    "pcb_p6": _res.pcb_p6,
    "pcb_p4": _res.pcb_p4,
    "mlfn": _reid.mlfn,
    "osnet_x1_0": _os.osnet_x1_0,
    "osnet_x0_75": _os.osnet_x0_75,
    "osnet_x0_5": _os.osnet_x0_5,
    "osnet_x0_25": _os.osnet_x0_25,
    "osnet_ibn_x1_0": _os.osnet_ibn_x1_0,
    "osnet_ain_x1_0": _os.osnet_ain_x1_0,
    "osnet_ain_x0_75": _os.osnet_ain_x0_75,
    "osnet_ain_x0_5": _os.osnet_ain_x0_5,
    "osnet_ain_x0_25": _os.osnet_ain_x0_25,
}


def show_avai_models():
    """reference: basic_cnn_params/__init__.py:83-85."""
    print(sorted(MODEL_FACTORY))


def _check(name: str) -> None:
    if name not in MODEL_FACTORY:
        raise KeyError(f"Unknown model: {name}. Must be one of {sorted(MODEL_FACTORY)}")


def build_empty(name: str, num_classes: int) -> nn.Module:
    """The module on the ``meta`` device: shapes and names, no memory."""
    _check(name)
    with torch.device("meta"):
        return MODEL_FACTORY[name](num_classes)


def build_model(name: str, num_classes: int, seed: int = 0, device=None) -> nn.Module:
    """A zoo model with seeded weights (``common.init_weights``) on
    ``device`` (by default the current CUDA device; pass ``device='cpu'``
    without one), in eval mode."""
    _check(name)
    dev = default_device(device)
    model = build_empty(name, num_classes).to_empty(device=dev)
    return init_weights(model, seed).eval()


def model_param_count(name: str, num_classes: int = 1000) -> int:
    """The trainable count (BN running statistics and frozen BN biases out,
    as torch's ``requires_grad`` count), built on ``meta``: no memory, no
    card."""
    return count_params(build_empty(name, num_classes))
