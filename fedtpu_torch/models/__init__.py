"""The port's model zoo: all of ``fedtpu.models`` (slice 7, parts 1, 2a
and 2b).

Constructor names mirror fedtpu's (``MLP()``, ``LeNet()``, ``ResNet18()``,
``PreActResNet18()``, ``VGG('VGG19')``, ``DenseNet121()``,
``densenet_cifar()``, ``MobileNetV2()``, ``GoogLeNet()``,
``ResNeXt29_2x64d()``, ``SENet18()``, ``DPN26()``, ``ShuffleNetG2()``,
``ShuffleNetV2(net_size)``, ``EfficientNetB0()``, ``RegNetX_200MF()``,
``RegNetX_400MF()``, ``RegNetY_400MF()``, ``PNASNetA()``, ``PNASNetB()``,
``DLA()``, ``SimpleDLA()``, ...), and every model is reachable by
fedtpu's registry name through :func:`create`. EfficientNet-B0 is the one
model whose train mode draws random numbers: it takes them as keep masks
(:func:`fedtpu_torch.models.common.draw_masks`).
"""

from fedtpu_torch.models.registry import available, create

from fedtpu_torch.models.mlp import MLP
from fedtpu_torch.models.smallcnn import SmallCNN
from fedtpu_torch.models.lenet import LeNet
from fedtpu_torch.models.mobilenet import MobileNet
from fedtpu_torch.models.resnet import ResNet18, ResNet34, ResNet50, ResNet101, ResNet152
from fedtpu_torch.models.preact_resnet import (
    PreActResNet18,
    PreActResNet34,
    PreActResNet50,
    PreActResNet101,
    PreActResNet152,
)
from fedtpu_torch.models.vgg import VGG
from fedtpu_torch.models.densenet import (
    DenseNet121,
    DenseNet161,
    DenseNet169,
    DenseNet201,
    densenet_cifar,
)
from fedtpu_torch.models.mobilenetv2 import MobileNetV2
from fedtpu_torch.models.googlenet import GoogLeNet
from fedtpu_torch.models.resnext import (
    ResNeXt29_2x64d,
    ResNeXt29_4x64d,
    ResNeXt29_8x64d,
    ResNeXt29_32x4d,
)
from fedtpu_torch.models.senet import SENet18
from fedtpu_torch.models.dpn import DPN26, DPN92
from fedtpu_torch.models.shufflenet import ShuffleNetG2, ShuffleNetG3
from fedtpu_torch.models.shufflenetv2 import ShuffleNetV2
from fedtpu_torch.models.efficientnet import EfficientNetB0
from fedtpu_torch.models.regnet import RegNetX_200MF, RegNetX_400MF, RegNetY_400MF
from fedtpu_torch.models.pnasnet import PNASNetA, PNASNetB
from fedtpu_torch.models.dla import DLA
from fedtpu_torch.models.dla_simple import SimpleDLA

__all__ = [
    "available",
    "create",
    "MLP",
    "SmallCNN",
    "LeNet",
    "MobileNet",
    "ResNet18",
    "ResNet34",
    "ResNet50",
    "ResNet101",
    "ResNet152",
    "PreActResNet18",
    "PreActResNet34",
    "PreActResNet50",
    "PreActResNet101",
    "PreActResNet152",
    "VGG",
    "DenseNet121",
    "DenseNet161",
    "DenseNet169",
    "DenseNet201",
    "densenet_cifar",
    "MobileNetV2",
    "GoogLeNet",
    "ResNeXt29_2x64d",
    "ResNeXt29_4x64d",
    "ResNeXt29_8x64d",
    "ResNeXt29_32x4d",
    "SENet18",
    "DPN26",
    "DPN92",
    "ShuffleNetG2",
    "ShuffleNetG3",
    "ShuffleNetV2",
    "EfficientNetB0",
    "RegNetX_200MF",
    "RegNetX_400MF",
    "RegNetY_400MF",
    "PNASNetA",
    "PNASNetB",
    "DLA",
    "SimpleDLA",
]
