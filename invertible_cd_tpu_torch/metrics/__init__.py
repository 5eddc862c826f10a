"""The metric suite (FID, LPIPS, CLIP, DINOv2, ImageReward, PSNR) of the port.

Counterpart of `invertible_cd_tpu/metrics/`, module for module, plus
`resize.py` (JAX's antialiased resize rule, which the preprocessing uses).
"""
from .basic import batch_psnr, mse, psnr
from .fid import FIDScorer
from .frechet import compute_statistics, frechet_distance, frechet_from_features
from .image_reward import BertConfig, ImageReward, make_image_reward_fn
from .inception import InceptionV3Features
from .lpips import LPIPS, VGG16Features
from .scores import Evaluators, evaluators_from_weights, make_random_evaluators
from .vit import ViTConfig, ViTEncoder, preprocess_for

__all__ = [
    "batch_psnr", "mse", "psnr", "FIDScorer", "compute_statistics", "frechet_distance",
    "frechet_from_features", "BertConfig", "ImageReward", "make_image_reward_fn",
    "InceptionV3Features", "LPIPS", "VGG16Features", "Evaluators", "evaluators_from_weights",
    "make_random_evaluators", "ViTConfig", "ViTEncoder", "preprocess_for",
]
