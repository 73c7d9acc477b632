from .bisample import (gumbel_softmax_weights, gumbel_uniform,
                       project_log_softmax, sample_gumbel_excluding,
                       sample_gumbel_indices, sample_max_alphas,
                       sample_min_alphas, sample_random_excluding)
from .elasticity import (bound_clip, fit_mc_num_by_latency,
                         rewrite_masks_by_l1, shrink_or_expand)
from .parser import (get_mc_num_dddict, get_op_and_depth_weights,
                     parse_architecture)
from .train_step import (adam_init, cosine_lr_list, make_search_steps,
                         zeros_like_tree)

__all__ = [
    "gumbel_softmax_weights", "gumbel_uniform", "project_log_softmax",
    "sample_gumbel_excluding", "sample_gumbel_indices", "sample_max_alphas",
    "sample_min_alphas", "sample_random_excluding", "bound_clip",
    "fit_mc_num_by_latency", "rewrite_masks_by_l1", "shrink_or_expand",
    "get_mc_num_dddict", "get_op_and_depth_weights", "parse_architecture",
    "adam_init", "cosine_lr_list", "make_search_steps", "zeros_like_tree",
]
