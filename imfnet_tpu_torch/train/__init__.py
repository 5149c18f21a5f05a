"""Training: the losses, the step, the train state and checkpoints, the
validation step and the ``Trainer`` around them."""
from imfnet_tpu_torch.train.losses import (  # noqa: F401
    contrastive_loss,
    hardest_contrastive_loss,
    hardest_triplet_loss,
    triplet_loss,
)
