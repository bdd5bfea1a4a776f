"""The CNN zoo's short facade (``editor_tpu/models/cnn_zoo.py``): the zoo's
API plus ``build_cnn`` / ``cnn_param_count`` and the aliases ``mobilenetv2``
and ``shufflenetv2``."""

from __future__ import annotations

from torch import nn

from editor_tpu_torch.models.zoo import (  # noqa: F401
    MODEL_FACTORY, build_model, model_param_count, show_avai_models,
)

_ALIASES = {
    "mobilenetv2": "mobilenetv2_x1_0",
    "shufflenetv2": "shufflenet_v2_x1_0",
}

CNN_FACTORY = MODEL_FACTORY


def _resolve(name: str) -> str:
    return _ALIASES.get(name, name)


def build_cnn(name: str, num_classes: int, seed: int = 0, device=None) -> nn.Module:
    """``build_model`` under the facade's names. JAX's ``build_cnn`` returns
    ``(params, apply)`` with an ignored ``num_classes_head`` flag; here the
    module's forward gives the logits."""
    return build_model(_resolve(name), num_classes, seed=seed, device=device)


def cnn_param_count(name: str, num_classes: int = 1000) -> int:
    return model_param_count(_resolve(name), num_classes)
