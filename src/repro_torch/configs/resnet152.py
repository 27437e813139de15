"""ResNet-152 -- the paper's headline CNN."""
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.models import resnet
from repro_torch.models.api import ModelAPI
from repro_torch.models.resnet import ResNetConfig

FULL = ResNetConfig(name="resnet152", depth=152, n_classes=1000, img_size=224)
REDUCED = ResNetConfig(name="resnet152-smoke", depth=152, n_classes=10,
                       img_size=32)


def build(policy=None, reduced=False):
    return ModelAPI(name=FULL.name, family="cnn",
                    cfg=REDUCED if reduced else FULL, mod=resnet,
                    policy=policy or PrecisionPolicy(inner_bits=2, k=2))
