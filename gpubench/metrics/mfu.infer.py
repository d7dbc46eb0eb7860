"""The requests' model FLOPs over the stretch's wall time and the peak."""
from bench.readers import mfu_percent


def read(summary):
    return mfu_percent(summary)
