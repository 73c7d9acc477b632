from . import native

__all__ = ["native"]
