from .lut import (build_space_analytic_lut, get_lookup_latency,
                  lat_vectors_for_mc, load_lat_lookup)

__all__ = ["build_space_analytic_lut", "get_lookup_latency",
           "lat_vectors_for_mc", "load_lat_lookup"]
