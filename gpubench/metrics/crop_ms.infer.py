"""Device ms a request of the crop gather, normalization and upload: the
request range less the model range."""
from bench.readers import difference_ms


def read(summary):
    return difference_ms(summary, "gpubench/request", ("gpubench/model",))
