"""The share of the traced stretch of steps with no kernel running."""
from bench.readers import idle_percent


def read(summary):
    return idle_percent(summary)
