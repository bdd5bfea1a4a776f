"""editor_tpu_torch: the PyTorch / CUDA port of editor_tpu for NVIDIA Hopper.

The JAX package ``editor_tpu`` is the reference this port is held against;
nothing here imports JAX or ``editor_tpu``. The ported slices are the
tri-modal eval forward with its feature-serving path, the train step, and
the training and evaluation entry points on one device:

* :mod:`editor_tpu_torch.models` - ``Editor`` (state_dict keys of the
  reference; eval and training forward), ``editor_init`` (seeded weights),
  ``editor_config_from`` (a ``Config`` to the model's config, as in JAX) and
  ``flagship_config``; both build on the current CUDA device unless given a
  device;
* :mod:`editor_tpu_torch.ops` - the attention ops and their VJPs, and the
  fused LayerNorm -> matmul, each a hand-written CUDA kernel (``csrc/``)
  beside its plain PyTorch version;
* :mod:`editor_tpu_torch.engine` - ``build_eval_step``, ``do_inference``,
  ``build_train_step`` and the training loop ``loop.do_train``;
* :mod:`editor_tpu_torch.cli` - ``train``, ``test`` and ``params``;
* :mod:`editor_tpu_torch.data` - datasets, the P x K sampler, the loader, the
  eval transform and train augmentation;
* :mod:`editor_tpu_torch.evals` - CMC/mAP (``R1mAPEvaluator``) and
  k-reciprocal re-ranking;
* :mod:`editor_tpu_torch.losses`, :mod:`editor_tpu_torch.solver`,
  :mod:`editor_tpu_torch.config` - the train step's losses, optimizer and
  LR schedule, and the config dataclasses;
* :mod:`editor_tpu_torch.serve` - ``FeatureExtractor`` and ``GalleryIndex``;
* :mod:`editor_tpu_torch.utils` - full-state checkpoints, the logger and
  metric stream, ImageNet import, and ``jax_weights`` (JAX params ->
  state_dict).
"""

from editor_tpu_torch.engine.evaluate import build_eval_step
from editor_tpu_torch.engine.train import build_train_step
from editor_tpu_torch.models import (Editor, EditorConfig, ViTConfig, editor_config_from,
                                     editor_init, flagship_config)
from editor_tpu_torch.serve import FeatureExtractor, GalleryIndex

__all__ = ["Editor", "EditorConfig", "FeatureExtractor", "GalleryIndex", "ViTConfig",
           "build_eval_step", "build_train_step", "editor_config_from", "editor_init",
           "flagship_config"]
