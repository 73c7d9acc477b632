"""Device ms per traced request of the fused epilogue kernel
(tfnas_tpu_torch/csrc/bias_act.cu, every kernel name holding
`tfnas_bias_act`), from the profiler trace; nothing where no request
launched it."""

from benchmark import readers


def read(rec):
    return readers.kernel_ms_per(rec, "tfnas_bias_act", "requests")
