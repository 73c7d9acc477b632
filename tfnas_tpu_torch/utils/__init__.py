from .checkpoint import (load_checkpoint, save_checkpoint,
                         save_checkpoint_file, to_numpy_tree)
from .exp import setup_experiment
from .meters import AverageMeter
from .metrics import (accuracy, cross_entropy, cross_entropy_label_smooth,
                      masked_mean)

__all__ = [
    "load_checkpoint", "save_checkpoint", "save_checkpoint_file", "to_numpy_tree",
    "setup_experiment", "AverageMeter", "accuracy", "cross_entropy",
    "cross_entropy_label_smooth", "masked_mean",
]
