"""Device ms a request under `model.uncert_head`."""
from bench.readers import per_call_ms


def read(summary):
    return per_call_ms(summary, "gpubench/uncert_head")
