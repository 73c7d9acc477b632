from . import search_space
from .eval_net import EvalNetwork
from .supernet import BlockSite, SuperNetwork, block_sites

__all__ = ["search_space", "EvalNetwork", "BlockSite", "SuperNetwork",
           "block_sites"]
