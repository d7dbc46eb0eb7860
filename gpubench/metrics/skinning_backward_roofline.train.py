"""The least time of the skinning backward's work at the step's shape over
the device time of the kernels under `poco_tpu_torch::skinning_backward`, a call."""
from bench.peaks import backward_bound_s
from bench.readers import roofline_percent


def read(summary):
    return roofline_percent(summary, "poco_tpu_torch::skinning_backward",
                            "skinning_backward_shape", backward_bound_s)
