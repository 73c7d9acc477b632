from .imagelist import (DataLoader, DevicePrefetcher, ImageList,
                        default_list_reader, pil_loader)
from .synthetic import SyntheticImages, device_batches, synthetic_loader
from .transforms import IMAGENET_MEAN, IMAGENET_STD, device_normalizer

__all__ = ["DataLoader", "DevicePrefetcher", "ImageList",
           "default_list_reader", "pil_loader", "SyntheticImages",
           "device_batches", "synthetic_loader", "IMAGENET_MEAN",
           "IMAGENET_STD", "device_normalizer"]
