"""Device ms a step under the program's `train_step/optimizer` range."""
from bench.readers import per_call_ms


def read(summary):
    return per_call_ms(summary, "train_step/optimizer")
