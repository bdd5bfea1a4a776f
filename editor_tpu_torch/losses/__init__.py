"""ReID losses: those of the train step (label-smoothed CE, batch-hard
triplet) and the auxiliary ones off it (center, cluster, range, hetero-center,
multi-modal margin, weighted-regularized triplet, label-smoothing CE)."""

from editor_tpu_torch.losses.center import center_loss, center_loss_init
from editor_tpu_torch.losses.make_loss import make_loss
from editor_tpu_torch.losses.softmax import (cross_entropy, cross_entropy_label_smooth,
                                             label_smoothing_ce)
from editor_tpu_torch.losses.triplet import (batch_hard_triplet, euclidean_dist,
                                             hard_example_mining, weighted_regularized_triplet)

__all__ = ["batch_hard_triplet", "center_loss", "center_loss_init", "cross_entropy",
           "cross_entropy_label_smooth", "euclidean_dist", "hard_example_mining",
           "label_smoothing_ce", "make_loss", "weighted_regularized_triplet"]
