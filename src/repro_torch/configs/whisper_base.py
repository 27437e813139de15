"""whisper-base [audio]: 6L (enc+dec) d512 8H ff2048 v51865; conv/mel
frontend is a STUB (the caller supplies precomputed frame embeddings).
Source: [arXiv:2212.04356; unverified]."""
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.models import whisper
from repro_torch.models.api import ModelAPI
from repro_torch.models.whisper import WhisperConfig

FULL = WhisperConfig(
    name="whisper-base", n_layers=6, d_model=512, n_heads=8, d_ff=2048,
    vocab=51865, n_audio=1536)  # 1500 padded to /16 for TP sharding

REDUCED = WhisperConfig(
    name="whisper-base-smoke", n_layers=2, d_model=64, n_heads=4, d_ff=128,
    vocab=227, n_audio=24, attn_chunk=16)


def build(policy=None, reduced=False):
    return ModelAPI(
        name=FULL.name, family="audio", cfg=REDUCED if reduced else FULL,
        mod=whisper, microbatches=2,
        policy=policy or PrecisionPolicy(inner_bits=4, k=4),
        needs_frames=True)
