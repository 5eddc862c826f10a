"""Metric harness: CLIP / DINOv2 / PSNR / LPIPS / ImageReward scoring.

PyTorch counterpart of `invertible_cd_tpu/metrics/scores.py`, the twin of
reference `utils/metrics.py` (C12):
  calc_clip_score_images_images  (metrics.py:211-245)  clip_image_image
  calc_clip_score_images_text    (metrics.py:248-280)  clip_image_text
  calc_dinov2_similarities       (metrics.py:176-207)  dino_image_image
  calculate_psnr / calculate_lpips (metrics.py:295-324) calc_inversion
  calc_all  (metrics.py:327-390), calc_inversion (metrics.py:392-435)

An `Evaluators` bundle holds whichever scorer modules have weights (each on
its own device, fp32); a metric whose module is missing returns None
(gated: the repository holds no published scorer weights). Images come in
as the JAX package's: float [0, 1] (B, H, W, 3), numpy or tensor; each
scorer moves them to its module's device. Every reduction to a score runs
there in fp32; the score is a Python float.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..models.clip import CLIPTextConfig, CLIPTextModel
from ..models.layers import fan_in_init_
from .basic import batch_psnr
from .lpips import LPIPS
from .precision import fp32_products
from .resize import resize
from .vit import (
    CLIP_IMAGE_MEAN, CLIP_IMAGE_STD, IMAGENET_MEAN, IMAGENET_STD, ViTConfig, ViTEncoder,
    preprocess_for,
)


def _device(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


def _nchw(images01, device) -> torch.Tensor:
    if not isinstance(images01, torch.Tensor):
        images01 = torch.from_numpy(np.ascontiguousarray(images01, np.float32))
    return images01.to(device=device, dtype=torch.float32).permute(0, 3, 1, 2)


def _unit(f: torch.Tensor) -> torch.Tensor:
    return f / (torch.linalg.vector_norm(f, dim=-1, keepdim=True) + 1e-10)


@dataclasses.dataclass
class Evaluators:
    """Scorer bundle; each field a module (or the ImageReward callable) or
    None. `clip_size` and `dino_size` are the ViTs' input sizes (224; the
    tiny test ViTs take 28)."""

    clip_vision: Optional[ViTEncoder] = None
    clip_text: Optional[CLIPTextModel] = None  # with a projection
    clip_tokenizer: Optional[object] = None
    dino: Optional[ViTEncoder] = None
    lpips: Optional[LPIPS] = None
    image_reward_fn: Optional[Callable] = None  # (images01, prompts) -> (B,) scores
    clip_size: int = 224
    dino_size: int = 224

    # -- feature extractors -------------------------------------------------
    @torch.inference_mode()
    def clip_image_features(self, images01) -> torch.Tensor:
        x = _nchw(images01, _device(self.clip_vision))
        return _unit(self.clip_vision(preprocess_for(x, self.clip_size, CLIP_IMAGE_MEAN,
                                                     CLIP_IMAGE_STD)))

    @torch.inference_mode()
    def clip_text_features(self, prompts: Sequence[str]) -> torch.Tensor:
        tokens = torch.as_tensor(np.asarray(self.clip_tokenizer(list(prompts))), dtype=torch.long,
                                 device=_device(self.clip_text))
        with fp32_products():  # the text encoder is the pipelines' module
            return _unit(self.clip_text(tokens)["projected_pooled"].float())

    @torch.inference_mode()
    def dino_features(self, images01) -> torch.Tensor:
        x = _nchw(images01, _device(self.dino))
        return _unit(self.dino(preprocess_for(x, self.dino_size, IMAGENET_MEAN, IMAGENET_STD)))

    # -- scores -------------------------------------------------------------
    def clip_image_image(self, a01, b01) -> Optional[float]:
        """Mean CLIP cosine between image pairs (preservation metric)."""
        if self.clip_vision is None:
            return None
        fa, fb = self.clip_image_features(a01), self.clip_image_features(b01)
        return float((fa * fb).sum(-1).mean())

    def clip_image_text(self, images01, prompts) -> Optional[float]:
        """Mean CLIP cosine between images and their prompts (editing fidelity)."""
        if self.clip_vision is None or self.clip_text is None:
            return None
        fi = self.clip_image_features(images01)
        ft = self.clip_text_features(prompts).to(fi.device)
        return float((fi * ft).sum(-1).mean())

    def dino_image_image(self, a01, b01) -> Optional[float]:
        if self.dino is None:
            return None
        fa, fb = self.dino_features(a01), self.dino_features(b01)
        return float((fa * fb).sum(-1).mean())

    @torch.inference_mode()
    def lpips_distance(self, a01, b01) -> Optional[float]:
        """Mean LPIPS at 224^2 (the reference's piq at 224, metrics.py:318-321),
        both images resized by JAX's bilinear rule."""
        if self.lpips is None:
            return None
        device = _device(self.lpips)
        a = resize(_nchw(a01, device), (224, 224), "bilinear")
        b = resize(_nchw(b01, device), (224, 224), "bilinear")
        return float(self.lpips(a * 2 - 1, b * 2 - 1).mean())

    def image_reward(self, images01, prompts) -> Optional[float]:
        if self.image_reward_fn is None:
            return None
        return float(np.mean(self.image_reward_fn(images01, prompts)))

    # -- batch scoring ------------------------------------------------------
    def calc_all(self, orig_images01, edited_images01, source_prompts: Sequence[str],
                 target_prompts: Sequence[str]) -> Dict[str, Optional[float]]:
        """The reference's editing bundle (metrics.py:327-390): preservation
        (CLIP-I/I and DINOv2 between original and edited) and editing
        fidelity (CLIP-I/T and ImageReward of edited against the target)."""
        return {
            "preservation_clip_image_image": self.clip_image_image(orig_images01, edited_images01),
            "preservation_dinov2": self.dino_image_image(orig_images01, edited_images01),
            "editing_clip_image_text": self.clip_image_text(edited_images01, target_prompts),
            "editing_image_reward": self.image_reward(edited_images01, target_prompts),
        }

    def calc_inversion(self, real_images01, reconstructed_images01) -> Dict[str, Optional[float]]:
        """Inversion quality bundle (metrics.py:392-435): DINOv2 similarity,
        PSNR (numpy float64) and LPIPS between the real image and its round
        trip."""
        def host(x):
            return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

        psnr = batch_psnr(host(real_images01) * 255.0, host(reconstructed_images01) * 255.0)
        return {
            "dinov2": self.dino_image_image(real_images01, reconstructed_images01),
            "psnr": float(np.mean(psnr)),
            "lpips": self.lpips_distance(real_images01, reconstructed_images01),
        }


def _ready(module: torch.nn.Module) -> torch.nn.Module:
    return module.eval().requires_grad_(False)


def make_random_evaluators(seed: int = 0, tiny: bool = True, device="cuda") -> Evaluators:
    """Seeded-weight evaluators (`scorer_modules(tiny, seed)`: CLIP vision
    and text, DINOv2, LPIPS; ImageReward gated, as in JAX) for tests; the
    scores are meaningless but the whole code path runs. As in JAX, the tiny
    bundle's CLIP and DINOv2 take 28^2 inputs."""
    from ..utils.tokenizer import HashTokenizer

    m = scorer_modules(tiny, seed=seed, device=device)
    size = ViTConfig.tiny().image_size if tiny else 224
    return Evaluators(clip_vision=m["clip_vision"], clip_text=m["clip_text"],
                      clip_tokenizer=HashTokenizer(vocab_size=m["clip_text"].cfg.vocab_size),
                      dino=m["dino"], lpips=m["lpips"], clip_size=size, dino_size=size)


def scorer_modules(tiny: bool = False, seed: Optional[int] = None,
                   device=None) -> Dict[str, torch.nn.Module]:
    """The scorer architectures by name, in eval mode on `device` (default:
    the current default device): "inception" (FID), "clip_vision" (ViT-L/14
    with its 768 projection), "clip_text" (ViT-L text with projection 768),
    "dino" (DINOv2 ViT-B/14), "lpips" (VGG16 + heads) and "image_reward"
    (BLIP ViT-L/16 + BERT-base). `tiny` swaps the ViTs, the text tower and
    ImageReward for the JAX tiny evaluators' configs (28^2 ViTs, a tiny CLIP
    text model projecting to 16, a tiny BERT); Inception and LPIPS keep
    their size. With `seed`, the weights are seeded by the fan-in rule
    (`models.layers.fan_in_init_`) from one generator, in the order above."""
    from .image_reward import BertConfig, ImageReward
    from .inception import InceptionV3Features

    if tiny:
        vcfg = ViTConfig.tiny()
        dcfg = dataclasses.replace(vcfg, projection_dim=None, layer_scale_init=1e-5, pre_ln=False)
        tcfg = dataclasses.replace(CLIPTextConfig.tiny(), projection_dim=vcfg.projection_dim)
        ir_vcfg = dataclasses.replace(vcfg, projection_dim=None)
        bcfg = BertConfig.tiny(encoder_width=ir_vcfg.hidden_size)
    else:
        vcfg, dcfg = ViTConfig.clip_vit_l14(), ViTConfig.dinov2_vit_b14()
        tcfg = dataclasses.replace(CLIPTextConfig.vit_l(), projection_dim=768)
        ir_vcfg, bcfg = ViTConfig.blip_vit_l16(), BertConfig()
    with torch.device(device) if device is not None else contextlib.nullcontext():
        modules = {"inception": InceptionV3Features(), "clip_vision": ViTEncoder(vcfg),
                   "clip_text": CLIPTextModel(tcfg), "dino": ViTEncoder(dcfg), "lpips": LPIPS(),
                   "image_reward": ImageReward(ir_vcfg, bcfg)}
    if seed is not None:
        gen = torch.Generator(device=device or "cpu").manual_seed(seed)
        for m in modules.values():
            fan_in_init_(m, gen)
    return {name: _ready(m) for name, m in modules.items()}


def _load(name: str, tiny: bool, state_dict, device) -> torch.nn.Module:
    """Scorer `name` (`scorer_modules`) built on the meta device, given the
    state dict's tensors (fp32) and moved to `device`."""
    with torch.device("meta"):
        module = scorer_modules(tiny)[name]
    module.load_state_dict({k: v.float().contiguous() for k, v in state_dict.items()}, assign=True)
    return _ready(module.to(device))


def evaluators_from_weights(
    clip_vision_path: Optional[str] = None,
    clip_text_path: Optional[str] = None,
    dino_path: Optional[str] = None,
    vgg_path: Optional[str] = None,
    lpips_heads_path: Optional[str] = None,
    image_reward_path: Optional[str] = None,
    bert_vocab_path: Optional[str] = None,
    tokenizer=None,
    device="cuda",
    tiny: bool = False,
) -> Evaluators:
    """Real evaluators from the published torch checkpoints, through the
    converters of `models.convert` (the loading the reference gets from
    transformers / torch-hub / piq downloads, `utils/metrics.py:139-321`).
    A missing path leaves its metric gated (None); LPIPS needs both VGG and
    head files, ImageReward its checkpoint and the BERT vocab. `tiny` reads
    checkpoints of `scorer_modules(tiny=True)`'s architectures (the tiny
    model's tests), with 28^2 ViT inputs and, by default, the hash tokenizer
    over the tiny CLIP vocabulary."""
    from ..models import convert as C
    from ..utils.tokenizer import BertWordPieceTokenizer, HashTokenizer, default_tokenizer
    from .image_reward import make_image_reward_fn

    if tokenizer is None:
        tokenizer = HashTokenizer(CLIPTextConfig.tiny().vocab_size) if tiny else default_tokenizer()
    size = ViTConfig.tiny().image_size if tiny else 224
    ev = Evaluators(clip_tokenizer=tokenizer, clip_size=size, dino_size=size)
    if clip_vision_path:
        ev.clip_vision = _load("clip_vision", tiny, C.convert_clip_vision_from_transformers(
            C.load_torch_file(clip_vision_path)), device)
    if clip_text_path:
        ev.clip_text = _load("clip_text", tiny, C.convert_clip_text_from_transformers(
            C.load_torch_file(clip_text_path)), device)
    if dino_path:
        ev.dino = _load("dino", tiny, C.convert_dinov2_weights(
            C.load_torch_file(dino_path), ViTConfig.tiny() if tiny else ViTConfig.dinov2_vit_b14()),
            device)
    if vgg_path and lpips_heads_path:
        ev.lpips = _load("lpips", tiny, C.convert_lpips_weights(
            C.load_torch_file(vgg_path), C.load_torch_file(lpips_heads_path)), device)
    if image_reward_path and bert_vocab_path:
        module = _load("image_reward", tiny, C.convert_image_reward_weights(
            C.load_torch_file(image_reward_path),
            ViTConfig.tiny() if tiny else ViTConfig.blip_vit_l16()), device)
        ev.image_reward_fn = make_image_reward_fn(module, BertWordPieceTokenizer(bert_vocab_path))
    return ev
