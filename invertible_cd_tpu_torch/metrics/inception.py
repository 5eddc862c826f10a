"""InceptionV3 (the FID variant) in PyTorch, NCHW.

PyTorch counterpart of `invertible_cd_tpu/metrics/inception.py`, itself the
twin of the reference's vendored pytorch-fid network (SURVEY.md C13):
torchvision's inception_v3 with every average pool excluding padding from
its divisor, a max pool in Mixed_7c's pool branch, and no classifier; the
2048 pool3 activations are the FID features.

Module names are those of the published `pt_inception-2015-12-05` state
dict (`Conv2d_1a_3x3.conv.weight`, `Mixed_5b.branch1x1.bn.running_var`,
...), so `models.convert.convert_inception_weights` only drops the keys the
features do not use. BatchNorm runs on its stored statistics, eps 1e-3, in
fp32 (JAX :48-49).

Input: float images in [0, 1], (B, 3, H, W); resized to 299^2 by JAX's
bilinear rule (`metrics.resize`; antialiased when shrinking) and scaled to
[-1, 1] inside the model, each step switchable as in JAX.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .precision import fp32_products
from .resize import resize

Pair = Tuple[int, int]


class BatchNorm(nn.Module):
    """Inference BatchNorm on stored statistics (affine, eps 1e-3), fp32."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        return F.batch_norm(x.float(), self.running_mean, self.running_var, self.weight,
                            self.bias, training=False, eps=self.eps)


class ConvBN(nn.Module):
    """conv (no bias) -> BatchNorm -> relu (JAX `ConvBN`, :31-52)."""

    def __init__(self, cin: int, cout: int, kernel: Pair, stride: int = 1, padding: Pair = (0, 0)):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x.to(self.conv.weight.dtype))))


def _avg_pool_nopad(x):
    """3x3 stride-1 average pool, padding excluded from the divisor (JAX :55-66)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _max_pool(x):
    """3x3 stride-2 max pool without padding (JAX :69-73)."""
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = ConvBN(cin, 64, (1, 1))
        self.branch5x5_1 = ConvBN(cin, 48, (1, 1))
        self.branch5x5_2 = ConvBN(48, 64, (5, 5), padding=(2, 2))
        self.branch3x3dbl_1 = ConvBN(cin, 64, (1, 1))
        self.branch3x3dbl_2 = ConvBN(64, 96, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3 = ConvBN(96, 96, (3, 3), padding=(1, 1))
        self.branch_pool = ConvBN(cin, pool_features, (1, 1))

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg_pool_nopad(x))], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = ConvBN(cin, 384, (3, 3), stride=2)
        self.branch3x3dbl_1 = ConvBN(cin, 64, (1, 1))
        self.branch3x3dbl_2 = ConvBN(64, 96, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3 = ConvBN(96, 96, (3, 3), stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        p17, p71 = (0, 3), (3, 0)
        self.branch1x1 = ConvBN(cin, 192, (1, 1))
        self.branch7x7_1 = ConvBN(cin, c7, (1, 1))
        self.branch7x7_2 = ConvBN(c7, c7, (1, 7), padding=p17)
        self.branch7x7_3 = ConvBN(c7, 192, (7, 1), padding=p71)
        self.branch7x7dbl_1 = ConvBN(cin, c7, (1, 1))
        self.branch7x7dbl_2 = ConvBN(c7, c7, (7, 1), padding=p71)
        self.branch7x7dbl_3 = ConvBN(c7, c7, (1, 7), padding=p17)
        self.branch7x7dbl_4 = ConvBN(c7, c7, (7, 1), padding=p71)
        self.branch7x7dbl_5 = ConvBN(c7, 192, (1, 7), padding=p17)
        self.branch_pool = ConvBN(cin, 192, (1, 1))

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                     self.branch7x7dbl_5):
            bd = conv(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool_nopad(x))], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = ConvBN(cin, 192, (1, 1))
        self.branch3x3_2 = ConvBN(192, 320, (3, 3), stride=2)
        self.branch7x7x3_1 = ConvBN(cin, 192, (1, 1))
        self.branch7x7x3_2 = ConvBN(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = ConvBN(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = ConvBN(192, 192, (3, 3), stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for conv in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([b3, b7, _max_pool(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, use_max_pool: bool = False):
        super().__init__()
        self.use_max_pool = use_max_pool  # Mixed_7c (pytorch-fid's FIDInceptionE_2)
        self.branch1x1 = ConvBN(cin, 320, (1, 1))
        self.branch3x3_1 = ConvBN(cin, 384, (1, 1))
        self.branch3x3_2a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = ConvBN(cin, 448, (1, 1))
        self.branch3x3dbl_2 = ConvBN(448, 384, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = ConvBN(cin, 192, (1, 1))

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        bp = F.max_pool2d(x, 3, stride=1, padding=1) if self.use_max_pool else _avg_pool_nopad(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], dim=1)


class InceptionV3Features(nn.Module):
    """The FID feature extractor: images [0, 1] (B, 3, H, W) -> (B, 2048) fp32."""

    def __init__(self, resize_input: bool = True, normalize_input: bool = True):
        super().__init__()
        self.resize_input = resize_input
        self.normalize_input = normalize_input
        self.Conv2d_1a_3x3 = ConvBN(3, 32, (3, 3), stride=2)
        self.Conv2d_2a_3x3 = ConvBN(32, 32, (3, 3))
        self.Conv2d_2b_3x3 = ConvBN(32, 64, (3, 3), padding=(1, 1))
        self.Conv2d_3b_1x1 = ConvBN(64, 80, (1, 1))
        self.Conv2d_4a_3x3 = ConvBN(80, 192, (3, 3))
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
        self.Mixed_7c = InceptionE(2048, use_max_pool=True)

    @fp32_products()
    def forward(self, x):
        x = x.float()
        if self.resize_input:
            x = resize(x, (299, 299), "bilinear")
        if self.normalize_input:
            x = 2.0 * x - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool(x)
        x = _max_pool(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)))
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a, self.Mixed_6b,
                      self.Mixed_6c, self.Mixed_6d, self.Mixed_6e, self.Mixed_7a, self.Mixed_7b,
                      self.Mixed_7c):
            x = block(x)
        return x.float().mean(dim=(2, 3))  # adaptive average pool -> (B, 2048)
