"""Device ms a request under `model.backbone`."""
from bench.readers import per_call_ms


def read(summary):
    return per_call_ms(summary, "gpubench/backbone")
