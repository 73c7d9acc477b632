from . import search_space
from .supernet import BlockSite, SuperNetwork, block_sites

__all__ = ["search_space", "BlockSite", "SuperNetwork", "block_sites"]
