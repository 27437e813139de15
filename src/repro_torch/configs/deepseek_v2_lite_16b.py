"""deepseek-v2-lite-16b [moe]: 27L d2048 16H, MLA kv_lora=512, expert
ff 1408, 64 routed experts top-6 + 2 shared, first layer dense
(ff 10944), vocab 102400.  Source: [arXiv:2405.04434; hf].  The HF
deepseek-v2-lite config has 64 routed experts, which this follows."""
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.models import transformer
from repro_torch.models.api import ModelAPI
from repro_torch.models.transformer import MLAConfig, TransformerConfig
from repro_torch.nn.moe import MoEConfig

FULL = TransformerConfig(
    name="deepseek-v2-lite-16b", n_layers=27, d_model=2048, n_heads=16,
    n_kv=16, d_ff=1408, vocab=102400, act="swiglu", family="moe",
    mla=MLAConfig(kv_lora=512, qk_nope=128, qk_rope=64, v_head=128),
    moe=MoEConfig(d_model=2048, d_ff=1408, n_experts=64, topk=6,
                  n_shared=2, shared_ff=1408, capacity_factor=2.0),
    dense_first_n=1, dense_ff=10944)

REDUCED = TransformerConfig(
    name="deepseek-v2-lite-16b-smoke", n_layers=3, d_model=64, n_heads=4,
    n_kv=4, d_ff=32, vocab=223, act="swiglu", family="moe", attn_chunk=16,
    mla=MLAConfig(kv_lora=32, qk_nope=16, qk_rope=8, v_head=16),
    moe=MoEConfig(d_model=64, d_ff=32, n_experts=8, topk=2, n_shared=2,
                  shared_ff=32, capacity_factor=2.0),
    dense_first_n=1, dense_ff=128)


def build(policy=None, reduced=False):
    return ModelAPI(
        name=FULL.name, family="moe", cfg=REDUCED if reduced else FULL,
        mod=transformer, microbatches=8,
        policy=policy or PrecisionPolicy(inner_bits=4, k=4))
