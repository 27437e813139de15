"""chameleon-34b [vlm]: 48L d8192 64H (GQA kv=8) ff22016 v65536.
Early-fusion VLM -- the VQ image tokenizer is a stub: input token ids
already include the image-token range, so the backbone is a dense decoder
LM over the fused vocabulary.
Source: [arXiv:2405.09818; unverified]."""
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.models import transformer
from repro_torch.models.api import ModelAPI
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="chameleon-34b", n_layers=48, d_model=8192, n_heads=64, n_kv=8,
    d_ff=22016, vocab=65536, act="swiglu", family="vlm", attn_impl="flash")

REDUCED = TransformerConfig(
    name="chameleon-34b-smoke", n_layers=3, d_model=64, n_heads=8, n_kv=2,
    d_ff=96, vocab=256, act="swiglu", family="vlm", attn_chunk=16)


def build(policy=None, reduced=False):
    return ModelAPI(
        name=FULL.name, family="vlm", cfg=REDUCED if reduced else FULL,
        mod=transformer, policy=policy or PrecisionPolicy(inner_bits=4, k=4),
        microbatches=16)
