from .train_dp import (EvalTrainState, cosine_lr_with_warmup,
                       init_eval_train_state, make_eval_steps)

__all__ = ["EvalTrainState", "cosine_lr_with_warmup",
           "init_eval_train_state", "make_eval_steps"]
