"""yi-34b [dense]: 60L d7168 56H (GQA kv=8) ff20480 v64000.
Source: 01.AI Yi [arXiv:2403.04652; hf]."""
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.models import transformer
from repro_torch.models.api import ModelAPI
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="yi-34b", n_layers=60, d_model=7168, n_heads=56, n_kv=8,
    d_ff=20480, vocab=64000, act="swiglu", family="dense", attn_impl="flash")

REDUCED = TransformerConfig(
    name="yi-34b-smoke", n_layers=3, d_model=56, n_heads=7, n_kv=1,
    d_ff=112, vocab=199, act="swiglu", family="dense", attn_chunk=16)


def build(policy=None, reduced=False):
    return ModelAPI(
        name=FULL.name, family="dense", cfg=REDUCED if reduced else FULL,
        mod=transformer, policy=policy or PrecisionPolicy(inner_bits=4, k=4),
        microbatches=16)
