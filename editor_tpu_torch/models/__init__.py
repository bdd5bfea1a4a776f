"""EDITOR model of the editor_tpu_torch port (eval and training forward)."""

from editor_tpu_torch.models.editor import (VIT_FACTORY, Editor, EditorConfig,
                                            EditorTrainOutput, editor_config_from,
                                            flagship_config)
from editor_tpu_torch.models.init import editor_init
from editor_tpu_torch.models.vit import ViTConfig, VisionTransformer

__all__ = ["Editor", "EditorConfig", "EditorTrainOutput", "VIT_FACTORY", "ViTConfig",
           "VisionTransformer", "editor_config_from", "editor_init", "flagship_config"]
