"""The share of the traced stretch of requests with no kernel running."""
from bench.readers import idle_percent


def read(summary):
    return idle_percent(summary)
