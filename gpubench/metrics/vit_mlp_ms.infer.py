"""Device ms a request under the program's `poco/vit_mlp` spans: every
ViT block's LayerNorm, fc1, GELU and fc2."""
from bench.readers import per_call_ms


def read(summary):
    return per_call_ms(summary, "poco/vit_mlp")
