"""Device ms a request of SMPL, the cameras and the glue: the model range
less its backbone, head and uncertainty ranges."""
from bench.readers import difference_ms


def read(summary):
    return difference_ms(summary, "gpubench/model",
                         ("gpubench/backbone", "gpubench/head", "gpubench/uncert_head"))
