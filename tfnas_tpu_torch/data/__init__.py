from .synthetic import SyntheticImages, device_batches, synthetic_loader

__all__ = ["SyntheticImages", "device_batches", "synthetic_loader"]
