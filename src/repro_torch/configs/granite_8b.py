"""granite-8b [dense]: 36L d4096 32H (GQA kv=8) ff14336 v49152.
Source: IBM Granite Code 8B [arXiv:2405.04324; hf]."""
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.models import transformer
from repro_torch.models.api import ModelAPI
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="granite-8b", n_layers=36, d_model=4096, n_heads=32, n_kv=8,
    d_ff=14336, vocab=49152, act="swiglu", family="dense", attn_impl="flash",
    remat_policy="dots")

REDUCED = TransformerConfig(
    name="granite-8b-smoke", n_layers=3, d_model=64, n_heads=4, n_kv=2,
    d_ff=128, vocab=251, act="swiglu", family="dense", attn_chunk=16)


def build(policy=None, reduced=False):
    return ModelAPI(name=FULL.name, family="dense",
                    cfg=REDUCED if reduced else FULL, mod=transformer,
                    microbatches=16,
                    policy=policy or PrecisionPolicy(inner_bits=4, k=4))
