"""olmoe-1b-7b [moe]: 16L d2048 16H (kv=16, MHA) v50304; 64 experts
top-8, expert ff 1024.  Source: [arXiv:2409.02060; hf]."""
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.models import transformer
from repro_torch.models.api import ModelAPI
from repro_torch.models.transformer import TransformerConfig
from repro_torch.nn.moe import MoEConfig

FULL = TransformerConfig(
    name="olmoe-1b-7b", n_layers=16, d_model=2048, n_heads=16, n_kv=16,
    d_ff=0, vocab=50304, act="swiglu", family="moe",
    moe=MoEConfig(d_model=2048, d_ff=1024, n_experts=64, topk=8,
                  capacity_factor=2.0), attn_impl="flash")

REDUCED = TransformerConfig(
    name="olmoe-1b-7b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=4,
    d_ff=0, vocab=211, act="swiglu", family="moe", attn_chunk=16,
    moe=MoEConfig(d_model=64, d_ff=32, n_experts=8, topk=2,
                  capacity_factor=2.0))


def build(policy=None, reduced=False):
    return ModelAPI(
        name=FULL.name, family="moe", cfg=REDUCED if reduced else FULL,
        mod=transformer,
        # channel_wise=True: per-expert step sizes are the paper's
        # channel-wise quantization mapped onto the expert axis -- each
        # expert packs with its own gamma_w.
        microbatches=8,
        policy=policy or PrecisionPolicy(inner_bits=4, k=4,
                                         channel_wise=True))
