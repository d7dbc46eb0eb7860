"""The least time of one ViT block's MLP at the request shape
(`vit_mlp_shape`: tokens, width, hidden) over the device time under one
`poco/vit_mlp` span, a call."""
from bench.readers import roofline_percent
from bench.vit_bounds import mlp_bound_s


def read(summary):
    return roofline_percent(summary, "poco/vit_mlp", "vit_mlp_shape", mlp_bound_s)
