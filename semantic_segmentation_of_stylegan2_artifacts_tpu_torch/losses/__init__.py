from .losses import (  # noqa: F401
    bce_with_logits,
    dynamic_loss,
    dynamic_loss_per_sample,
    focal_tversky_loss,
    symmetric_unified_focal_loss,
    tversky_index,
    tversky_loss,
)
