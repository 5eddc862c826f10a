"""In-memory FID (reference C25, `training/src/fid_score_in_memory.py`).

PyTorch counterpart of `invertible_cd_tpu/metrics/fid.py`. `FIDScorer`
extracts InceptionV3 pool3 features on the model's device, batch by batch,
and compares them with a second image set or with reference statistics in
an `.npz` holding `mu` and `sigma` (the format of the reference's
`fid_stats_mscoco256_val.npz`; an npz written by either package loads in
the other). The Fréchet distance itself is numpy float64 on the host
(`frechet.py`).

Preprocessing as in JAX: a 256^2 LANCZOS short-side resize and centre crop
per image on the host (PIL), then, inside the network, the 299^2 bilinear
resize and the [-1, 1] scaling. `random_init` builds the network without
its resize, as JAX's does, and resizes and scales before calling it; the
network then scales again (JAX :62-69 and :212-213), which is kept so that
both packages compute the same features from the same weights. Chunks are
not padded: JAX pads the last one only to keep one compiled shape, and
drops the padded rows.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.layers import fan_in_init_
from .frechet import compute_statistics, frechet_distance
from .inception import InceptionV3Features
from .resize import resize


def _resize_crop_256(img: np.ndarray) -> np.ndarray:
    """uint8 HWC -> 256x256 uint8 (LANCZOS short-side resize + center crop)."""
    from PIL import Image

    pil = Image.fromarray(img)
    w, h = pil.size
    scale = 256 / min(w, h)
    pil = pil.resize((max(256, round(w * scale)), max(256, round(h * scale))), Image.LANCZOS)
    w, h = pil.size
    left, top = (w - 256) // 2, (h - 256) // 2
    return np.asarray(pil.crop((left, top, left + 256, top + 256)))


class FIDScorer:
    """FID features and distances over an `InceptionV3Features` model, which
    sets the device (fp32)."""

    def __init__(self, model: InceptionV3Features, batch_size: int = 50):
        self.model = model.eval().requires_grad_(False)
        self.batch_size = batch_size

    @property
    def device(self) -> torch.device:
        return self.model.Conv2d_1a_3x3.conv.weight.device

    @staticmethod
    def from_state_dict(state_dict: Dict[str, torch.Tensor], device="cuda",
                        batch_size: int = 50) -> "FIDScorer":
        """A scorer over weights in this package's key names (the published
        FID-Inception names; `models.convert.convert_inception_weights`)."""
        with torch.device("meta"):
            model = InceptionV3Features()
        model.load_state_dict({k: v.float().contiguous() for k, v in state_dict.items()},
                              assign=True)
        return FIDScorer(model.to(device), batch_size)

    @staticmethod
    def random_init(seed: int = 0, device="cuda") -> "FIDScorer":
        """Architecture-only scorer with seeded weights (fan-in rule,
        `models.layers.fan_in_init_`; tests and the card's smoke run; FID
        numbers need the published weights)."""
        with torch.device(device):
            model = InceptionV3Features(resize_input=False)
        fan_in_init_(model, torch.Generator(device=device).manual_seed(seed))
        return FIDScorer(model)

    @torch.inference_mode()
    def features(self, images: Sequence[np.ndarray]) -> np.ndarray:
        """uint8 images (any size) -> (N, 2048) float32 pool3 features."""
        prepped = np.stack([_resize_crop_256(np.asarray(im)) for im in images])
        x = torch.from_numpy(prepped).to(self.device).permute(0, 3, 1, 2).float() / 255.0
        if not self.model.resize_input:  # random_init path
            x = resize(x, (299, 299), "bilinear") * 2 - 1
        out = [self.model(x[i:i + self.batch_size]).cpu().numpy()
               for i in range(0, x.shape[0], self.batch_size)]
        return np.concatenate(out, axis=0)

    def statistics(self, images: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
        return compute_statistics(self.features(images))

    def fid(self, images: Sequence[np.ndarray],
            reference_images: Optional[Sequence[np.ndarray]] = None,
            reference_stats_path: Optional[str] = None) -> float:
        """FID of `images` against reference images or a stats npz
        (reference `calculate_fid`, `fid_score_in_memory.py:243-270`)."""
        mu1, s1 = self.statistics(images)
        if reference_stats_path is not None:
            with np.load(reference_stats_path) as f:
                mu2, s2 = f["mu"], f["sigma"]
        else:
            if reference_images is None:
                raise ValueError("fid needs reference_images or reference_stats_path")
            mu2, s2 = self.statistics(reference_images)
        return frechet_distance(mu1, s1, mu2, s2)

    def save_statistics(self, images: Sequence[np.ndarray], path: str) -> None:
        mu, sigma = self.statistics(images)
        np.savez(path, mu=mu, sigma=sigma)
