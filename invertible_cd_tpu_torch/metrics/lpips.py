"""LPIPS perceptual distance (VGG16 backbone) in PyTorch, NCHW.

PyTorch counterpart of `invertible_cd_tpu/metrics/lpips.py`; the reference
computes LPIPS through `piq.LPIPS()` at 224^2 (`utils/metrics.py:310-324`).
The standard Zhang et al. LPIPS: VGG16's five stage outputs (relu1_2 ...
relu5_3), each unit-normalised over channels (x / (||x|| + 1e-10)), the
squared differences reduced by learned 1x1 heads without bias, averaged over
space and summed over stages.

Module names follow the JAX package's (`vgg.conv{stage}_{i}`, `lin{i}`);
`models.convert.convert_lpips_weights` maps torchvision's `vgg16().features`
and the LPIPS heads onto them.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .precision import fp32_products

VGG16_CFG: Tuple[Tuple[int, int], ...] = (
    # (num convs, channels) per stage; maxpool between stages
    (2, 64), (2, 128), (3, 256), (3, 512), (3, 512),
)

# ImageNet normalisation in the [-1, 1] convention LPIPS uses.
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """Returns the five post-ReLU stage outputs."""

    def __init__(self):
        super().__init__()
        cin = 3
        for stage, (n_convs, ch) in enumerate(VGG16_CFG):
            for i in range(n_convs):
                self.add_module(f"conv{stage}_{i}", nn.Conv2d(cin, ch, 3, padding=1))
                cin = ch

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for stage, (n_convs, _) in enumerate(VGG16_CFG):
            for i in range(n_convs):
                x = F.relu(getattr(self, f"conv{stage}_{i}")(x))
            feats.append(x)
            if stage < len(VGG16_CFG) - 1:
                x = F.max_pool2d(x, 2, stride=2)
        return feats


class LPIPS(nn.Module):
    """lpips(a, b): images in [-1, 1] (B, 3, H, W) -> (B,) fp32 distances."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for i, (_, ch) in enumerate(VGG16_CFG):
            self.add_module(f"lin{i}", nn.Conv2d(ch, 1, 1, bias=False))

    @fp32_products()
    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        shift = torch.tensor(_SHIFT, device=a.device, dtype=torch.float32)[None, :, None, None]
        scale = torch.tensor(_SCALE, device=a.device, dtype=torch.float32)[None, :, None, None]
        fa = self.vgg((a.float() - shift) / scale)
        fb = self.vgg((b.float() - shift) / scale)
        total = torch.zeros(a.shape[0], device=a.device, dtype=torch.float32)
        for i, (xa, xb) in enumerate(zip(fa, fb)):
            na = xa / (torch.linalg.vector_norm(xa, dim=1, keepdim=True) + 1e-10)
            nb = xb / (torch.linalg.vector_norm(xb, dim=1, keepdim=True) + 1e-10)
            head = getattr(self, f"lin{i}")((na - nb) ** 2)
            total = total + head.float().mean(dim=(1, 2, 3))
        return total
