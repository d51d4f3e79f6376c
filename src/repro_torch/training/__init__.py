"""Training side of the port: AdamW, EMA, the expert and router trainers,
the LM train step and checkpoint I/O (``repro.training``'s exports)."""

from repro_torch.training.checkpoint import (expert_metadata,
                                             load_checkpoint,
                                             save_checkpoint)
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_init, adamw_update,
                                            adamw_update_,
                                            clip_by_global_norm, ema_init,
                                            ema_update, global_norm,
                                            lr_schedule)
from repro_torch.training.trainer import (ExpertTrainer, RouterTrainer,
                                          TrainState, make_lm_train_step)
