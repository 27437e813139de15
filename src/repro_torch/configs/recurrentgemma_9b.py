"""recurrentgemma-9b [hybrid]: 38L d4096 16H (kv=1) ff12288 v256000;
RG-LRU + local attention (window 2048) in a 1-attention-per-3-layers
pattern.  Runs long_500k (O(window) decode state).
Source: [arXiv:2402.19427; unverified]."""
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.models import recurrentgemma
from repro_torch.models.api import ModelAPI
from repro_torch.models.recurrentgemma import RGConfig

FULL = RGConfig(
    name="recurrentgemma-9b", n_layers=38, d_model=4096, n_heads=16,
    n_kv=1, d_ff=12288, vocab=256000, window=2048, attn_impl="flash")

REDUCED = RGConfig(
    name="recurrentgemma-9b-smoke", n_layers=5, d_model=64, n_heads=4,
    n_kv=1, d_ff=128, vocab=233, window=8, attn_chunk=16)


def build(policy=None, reduced=False):
    return ModelAPI(
        name=FULL.name, family="hybrid", cfg=REDUCED if reduced else FULL,
        mod=recurrentgemma, microbatches=4,
        policy=policy or PrecisionPolicy(inner_bits=4, k=4),
        long_context_ok=True)
