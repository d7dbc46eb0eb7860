"""The least time of the skinning work at the request shape over the
device time of the kernels under `poco_tpu_torch::skinning`, a call."""
from bench.peaks import skinning_bound_s
from bench.readers import roofline_percent


def read(summary):
    return roofline_percent(summary, "poco_tpu_torch::skinning", "skinning_shape",
                            skinning_bound_s)
