from repro_torch.train.optimizer import (OptState, apply_updates,
                                         clip_by_global_norm, init_opt_state,
                                         lr_schedule)
from repro_torch.train.state import (TrainState, init_train_state,
                                     make_decode_step, make_eval_step,
                                     make_prefill_step, make_train_step)

__all__ = ["OptState", "apply_updates", "clip_by_global_norm",
           "init_opt_state", "lr_schedule", "TrainState", "init_train_state",
           "make_eval_step", "make_train_step", "make_prefill_step",
           "make_decode_step"]
