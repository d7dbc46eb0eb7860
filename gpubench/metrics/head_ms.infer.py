"""Device ms a request under `model.head`."""
from bench.readers import per_call_ms


def read(summary):
    return per_call_ms(summary, "gpubench/head")
