"""granite-34b [dense]: 88L d6144 48H (GQA kv=1 / MQA) ff24576 v49152.
Source: IBM Granite Code 34B [arXiv:2405.04324; hf]."""
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.models import transformer
from repro_torch.models.api import ModelAPI
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="granite-34b", n_layers=88, d_model=6144, n_heads=48, n_kv=1,
    d_ff=24576, vocab=49152, act="swiglu", family="dense", attn_impl="flash")

REDUCED = TransformerConfig(
    name="granite-34b-smoke", n_layers=3, d_model=64, n_heads=4, n_kv=1,
    d_ff=128, vocab=251, act="swiglu", family="dense", attn_chunk=16)


def build(policy=None, reduced=False):
    return ModelAPI(
        name=FULL.name, family="dense", cfg=REDUCED if reduced else FULL,
        mod=transformer, policy=policy or PrecisionPolicy(inner_bits=4, k=4),
        microbatches=16)
