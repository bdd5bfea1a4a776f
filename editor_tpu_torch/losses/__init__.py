"""ReID losses of the train step (label-smoothed CE, batch-hard triplet)."""

from editor_tpu_torch.losses.make_loss import make_loss
from editor_tpu_torch.losses.softmax import cross_entropy, cross_entropy_label_smooth
from editor_tpu_torch.losses.triplet import batch_hard_triplet, euclidean_dist, hard_example_mining

__all__ = ["batch_hard_triplet", "cross_entropy", "cross_entropy_label_smooth",
           "euclidean_dist", "hard_example_mining", "make_loss"]
