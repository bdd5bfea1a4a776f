"""EDITOR model of the editor_tpu_torch port (eval and training forward)."""

from editor_tpu_torch.models.editor import (Editor, EditorConfig, EditorTrainOutput,
                                            flagship_config)
from editor_tpu_torch.models.init import editor_init
from editor_tpu_torch.models.vit import ViTConfig, VisionTransformer

__all__ = ["Editor", "EditorConfig", "EditorTrainOutput", "ViTConfig", "VisionTransformer",
           "editor_init", "flagship_config"]
