"""nemotron-4-340b [dense]: 96L d18432 96H (GQA kv=8) ff73728 v256000;
squared-ReLU two-matrix MLP, head dim 192.
Source: [arXiv:2402.16819; unverified]."""
import torch

from repro_torch.core.precision import PrecisionPolicy
from repro_torch.models import transformer
from repro_torch.models.api import ModelAPI
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="nemotron-4-340b", n_layers=96, d_model=18432, n_heads=96, n_kv=8,
    d_ff=73728, vocab=256000, act="sq_relu", family="dense", attn_impl="flash")

REDUCED = TransformerConfig(
    name="nemotron-4-340b-smoke", n_layers=3, d_model=96, n_heads=6, n_kv=2,
    d_ff=192, vocab=239, act="sq_relu", family="dense", attn_chunk=16)


def build(policy=None, reduced=False):
    return ModelAPI(
        name=FULL.name, family="dense", cfg=REDUCED if reduced else FULL,
        mod=transformer, policy=policy or PrecisionPolicy(inner_bits=4, k=4),
        microbatches=16, opt_dtype=torch.bfloat16)  # 340B: moments in bf16
