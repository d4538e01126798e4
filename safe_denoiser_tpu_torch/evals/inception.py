"""FID InceptionV3, the pool3 feature extractor.

Counterpart of ``safe_denoiser_tpu/evals/inception.py``: pytorch-fid's
``pt_inception-2015-12-05`` variant of torchvision's inception_v3 with the
FID-specific deviations -- the average pools inside the blocks exclude the
padding from their count, Mixed_7b averages its pool branch while Mixed_7c
max-pools it, and the classifier has 1008 logits. Inference only: each
BatchNorm is applied from its running statistics at eps 1e-3 (not torch's
1e-5), in the JAX package's order.

The submodules carry pt_inception's names (``Conv2d_1a_3x3.conv.weight``,
``Mixed_7c.branch_pool.bn.running_var``, ``fc.weight``), so that state
dict loads directly. NCHW inside; the input is the JAX package's,
[B, 299, 299, 3] in [0, 1], mapped to [-1, 1]. The convolutions are
PyTorch's (cuDNN on the GPU), as JAX leaves them to XLA.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class InceptionConfig:
    normalize_input: bool = True
    num_classes: int = 1008


FID_INCEPTION = InceptionConfig()


def _avg_pool_edge_excl(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME average pool, padding excluded from the count."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 VALID max pool."""
    return F.max_pool2d(x, 3, stride=2)


class BasicConv2d(nn.Module):
    """Conv (no bias) -> BatchNorm from running statistics -> ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride,
                              padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn = self.bn

        def c(t):
            return t[:, None, None]

        x = self.conv(x)
        x = ((x - c(bn.running_mean)) * c(torch.rsqrt(bn.running_var
                                                     + bn.eps))
             * c(bn.weight) + c(bn.bias))
        return F.relu(x)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_edge_excl(x))
        return torch.cat([self.branch1x1(x), b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        row, col = dict(padding=(0, 3)), dict(padding=(3, 0))
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), **row)
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), **col)
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), **col)
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), **row)
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), **col)
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), **row)
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool_edge_excl(x))
        return torch.cat([self.branch1x1(x), b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool(x)], dim=1)


class InceptionE(nn.Module):
    """``max_branch_pool``: Mixed_7c's (FID Inception's E_2) max-pooled
    pool branch; Mixed_7b averages."""

    def __init__(self, cin: int, max_branch_pool: bool = False):
        super().__init__()
        self.max_branch_pool = max_branch_pool
        row, col = dict(padding=(0, 1)), dict(padding=(1, 0))
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), **row)
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), **col)
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), **row)
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), **col)
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       dim=1)
        bp = (F.max_pool2d(x, 3, stride=1, padding=1)
              if self.max_branch_pool else _avg_pool_edge_excl(x))
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)],
                         dim=1)


class InceptionV3(nn.Module):
    """forward(images [B, 299, 299, 3] in [0, 1]) ->
    (pool3 [B, 2048], logits [B, num_classes])."""

    def __init__(self, config: InceptionConfig = FID_INCEPTION):
        super().__init__()
        self.config = config
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048, max_branch_pool=True)
        self.fc = nn.Linear(2048, config.num_classes)

    def forward(self, images: torch.Tensor):
        x = images.to(self.fc.weight.dtype).permute(0, 3, 1, 2)
        if self.config.normalize_input:
            x = 2.0 * x - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max_pool(x)))
        x = _max_pool(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        pool3 = x.mean(dim=(2, 3))
        return pool3, self.fc(pool3)


def inception_state_dict(sd: dict) -> dict:
    """A pt_inception or torchvision inception_v3 state dict in this
    module's key set: the auxiliary classifier (``AuxLogits.*``, which
    torchvision's files carry) dropped, values as tensors."""
    return {k: torch.as_tensor(v) for k, v in sd.items()
            if not k.startswith("AuxLogits.")}


def init_random_(model: InceptionV3, generator: torch.Generator
                 ) -> InceptionV3:
    """Plumbing weights from ``generator``: each conv and the classifier
    ~ N(0, 2/fan_in) (He's variance, which keeps the signal through the
    ReLUs: at flax's 1/fan_in pool3 shrinks to ~1e-4 and barely depends
    on the image), the BatchNorms and the classifier's bias at
    identity."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, (2.0 / fan_in) ** 0.5,
                                 generator=generator)
            if isinstance(m, nn.Linear):
                m.bias.zero_()
    return model
