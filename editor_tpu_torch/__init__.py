"""editor_tpu_torch: the PyTorch / CUDA port of editor_tpu for NVIDIA Hopper.

The JAX package ``editor_tpu`` is the reference this port is held against;
nothing here imports JAX or ``editor_tpu``. The ported slice is the
tri-modal eval forward and its feature-serving path:

* :mod:`editor_tpu_torch.models` - ``Editor`` (state_dict keys of the
  reference), ``editor_init`` (seeded weights), ``flagship_config``;
* :mod:`editor_tpu_torch.ops` - the attention ops, each a hand-written CUDA
  kernel (``csrc/``) beside its plain PyTorch version;
* :mod:`editor_tpu_torch.engine.evaluate` - ``build_eval_step``;
* :mod:`editor_tpu_torch.serve` - ``FeatureExtractor`` and ``GalleryIndex``;
* :mod:`editor_tpu_torch.utils.jax_weights` - JAX params -> state_dict.
"""

from editor_tpu_torch.engine.evaluate import build_eval_step
from editor_tpu_torch.models import Editor, EditorConfig, ViTConfig, editor_init, flagship_config
from editor_tpu_torch.serve import FeatureExtractor, GalleryIndex

__all__ = ["Editor", "EditorConfig", "FeatureExtractor", "GalleryIndex", "ViTConfig",
           "build_eval_step", "editor_init", "flagship_config"]
