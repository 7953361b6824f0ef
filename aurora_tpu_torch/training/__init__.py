"""Fine-tuning on the card: AdamW, the latitude-weighted MAE loss and the train steps."""

from aurora_tpu_torch.training.train import (
    AdamW,
    adamw,
    lora_mask,
    mae_loss,
    make_rollout_train_step,
    make_train_step,
)

__all__ = ["AdamW", "adamw", "lora_mask", "mae_loss", "make_rollout_train_step",
           "make_train_step"]
