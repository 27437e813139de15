"""mamba2-1.3b [ssm]: 48L d2048, attention-free SSD, ssm_state=128,
vocab 50280.  Runs long_500k (constant-size state).
Source: [arXiv:2405.21060; unverified]."""
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.models import mamba2
from repro_torch.models.api import ModelAPI
from repro_torch.models.mamba2 import Mamba2Config
from repro_torch.nn.ssm import SSMConfig

FULL = Mamba2Config(
    name="mamba2-1.3b", n_layers=48, d_model=2048, vocab=50280,
    ssm=SSMConfig(d_model=2048, d_state=128, head_dim=64, expand=2,
                  n_groups=1, chunk=256))

REDUCED = Mamba2Config(
    name="mamba2-1.3b-smoke", n_layers=3, d_model=64, vocab=241,
    ssm=SSMConfig(d_model=64, d_state=16, head_dim=16, expand=2,
                  n_groups=1, chunk=16))


def build(policy=None, reduced=False):
    return ModelAPI(
        name=FULL.name, family="ssm", cfg=REDUCED if reduced else FULL,
        mod=mamba2, microbatches=4,
        policy=policy or PrecisionPolicy(inner_bits=4, k=4),
        long_context_ok=True)
