"""Device ms a request under the program's `poco/vit_attention` spans:
every ViT block's LayerNorm, qkv, attention and projection."""
from bench.readers import per_call_ms


def read(summary):
    return per_call_ms(summary, "poco/vit_attention")
