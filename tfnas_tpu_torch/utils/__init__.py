from .checkpoint import (load_checkpoint, save_checkpoint,
                         save_checkpoint_file, to_numpy_tree)
from .exp import setup_experiment, setup_rank_logging
from .meters import AverageMeter
from .metrics import (accuracy, cross_entropy, cross_entropy_label_smooth,
                      masked_mean)

__all__ = [
    "load_checkpoint", "save_checkpoint", "save_checkpoint_file", "to_numpy_tree",
    "setup_experiment", "setup_rank_logging", "AverageMeter", "accuracy", "cross_entropy",
    "cross_entropy_label_smooth", "masked_mean",
]
