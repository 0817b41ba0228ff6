"""The paper's own workloads (Table III): small CNN/MLP image classifiers.
Their convolutions lower to im2col matmuls on the ported NVDLA matmul
(``repro_torch.core.graph_ops``).  They are not ``ModelConfig``s and are kept
apart from the model registry in ``configs/__init__.py``.

Each net is described as a list of ops for the ``repro_torch.core.graph`` API:
  ("conv", out_ch, kh, kw, stride)  ("pool", k)  ("fc", out)  ("bn",)
"""
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class PaperNet:
    name: str
    input_shape: Tuple[int, int, int]   # H, W, C
    layers: Tuple[tuple, ...]
    n_classes: int


MINERVA = PaperNet(
    "minerva", (28, 28, 1),
    (("fc", 256), ("fc", 256), ("fc", 256)), 10)

LENET5 = PaperNet(
    "lenet5", (28, 28, 1),
    (("conv", 32, 3, 3, 1), ("conv", 32, 3, 3, 1), ("pool", 2), ("fc", 128)),
    10)

CNN10 = PaperNet(
    "cnn10", (32, 32, 3),
    (("conv", 32, 3, 3, 1), ("bn",), ("conv", 32, 3, 3, 1), ("pool", 2),
     ("conv", 64, 3, 3, 1), ("bn",), ("conv", 64, 3, 3, 1), ("pool", 2),
     ("fc", 512)),
    10)

VGG16_CIFAR = PaperNet(
    "vgg16", (32, 32, 3),
    (("conv", 64, 3, 3, 1), ("conv", 128, 3, 3, 1), ("pool", 2),
     ("conv", 128, 3, 3, 1), ("conv", 128, 3, 3, 1), ("pool", 2),
     ("conv", 256, 3, 3, 1), ("conv", 256, 3, 3, 1), ("conv", 256, 3, 3, 1), ("pool", 2),
     ("conv", 512, 3, 3, 1), ("conv", 512, 3, 3, 1), ("conv", 512, 3, 3, 1), ("pool", 2),
     ("fc", 512)),
    10)

ELU16 = PaperNet(
    "elu16", (32, 32, 3),
    (("conv", 192, 3, 3, 1), ("pool", 2),
     ("conv", 192, 1, 1, 1), ("conv", 240, 2, 2, 1), ("pool", 2),
     ("conv", 240, 1, 1, 1), ("conv", 260, 2, 2, 1), ("pool", 2),
     ("conv", 260, 1, 1, 1), ("conv", 280, 2, 2, 1), ("pool", 2),
     ("conv", 280, 1, 1, 1), ("conv", 300, 2, 2, 1), ("pool", 2),
     ("conv", 300, 1, 1, 1)),
    100)

PAPER_NETS = {n.name: n for n in (MINERVA, LENET5, CNN10, VGG16_CIFAR, ELU16)}
