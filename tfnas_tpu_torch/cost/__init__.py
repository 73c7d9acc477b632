from .flops import calculate_FLOPs_in_M, count_parameters_in_MB, layer_flops
from .lut import (build_space_analytic_lut, get_lookup_latency,
                  lat_vectors_for_mc, load_lat_lookup, save_lat_lookup)

__all__ = ["calculate_FLOPs_in_M", "count_parameters_in_MB", "layer_flops",
           "build_space_analytic_lut", "get_lookup_latency",
           "lat_vectors_for_mc", "load_lat_lookup", "save_lat_lookup"]
