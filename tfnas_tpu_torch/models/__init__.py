from . import hybrid_space, search_space
from .eval_net import EvalNetwork
from .supernet import BlockSite, SuperNetwork, block_sites
from .supernet_hybrid import HybridSuperNetwork

__all__ = ["hybrid_space", "search_space", "EvalNetwork", "BlockSite",
           "SuperNetwork", "HybridSuperNetwork", "block_sites"]
