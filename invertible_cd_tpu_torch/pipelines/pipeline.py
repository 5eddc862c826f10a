"""InvertibleCD — the user-facing pipeline bundling the UNet student, CLIP and VAE.

PyTorch counterpart of `invertible_cd_tpu/pipelines/pipeline.py` for the
generation path:

  generate():  CLIP encode -> 4 consistency hops -> VAE decode and clamp

Public functions keep the JAX package's layouts: latents (B, 64, 64, 4)
NHWC in, images (B, 512, 512, 3) float32 in [0, 1] NHWC out. Inside, the
models run NCHW. Inversion, editing, the DDIM baselines and SDXL come in
later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..diffusion.schedule import NoiseSchedule, make_schedule
from ..diffusion.solver import SolverGrid, make_solver_grid
from ..models.clip import CLIPTextConfig, CLIPTextModel
from ..models.layers import cast_compute_weights, fan_in_init_
from ..models.lora import merge_lora, seeded_lora
from ..models.unet2d import UNet2DCondition, UNetConfig
from ..models.vae import AutoencoderKL, VAEConfig
from ..utils.tokenizer import default_tokenizer
from . import sampler as S

UNET_KEYS = ("teacher", "reverse", "forward")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; a CUDA device must exist (pass
    device="cpu" to run on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


@dataclasses.dataclass
class InvertibleCD:
    """UNet student(s) + CLIP text encoder + VAE on one device.

    `unets` maps a model name ("reverse"; "teacher" and "forward" when
    given) to its UNet, with any LoRA already merged into the weights."""

    unets: Dict[str, UNet2DCondition]
    text_encoder: CLIPTextModel
    vae: AutoencoderKL
    tokenizer: object
    schedule: NoiseSchedule
    grid: SolverGrid
    scaling_factor: float = 0.18215
    latent_size: Tuple[int, int] = (64, 64)

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------
    @staticmethod
    def sd15(
        params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
        tokenizer=None,
        grid: Optional[SolverGrid] = None,
        dtype=torch.bfloat16,
        device="cuda",
        seed: int = 0,
        unet_cfg: Optional[UNetConfig] = None,
        clip_cfg: Optional[CLIPTextConfig] = None,
        vae_cfg: Optional[VAEConfig] = None,
        latent_size: Tuple[int, int] = (64, 64),
        lora_rank: int = 64,
    ) -> "InvertibleCD":
        """SD1.5 bundle on `device`, computing in `dtype`.

        `params` holds state dicts (diffusers / transformers keys) under
        "text", "vae" and one or more of "teacher", "reverse", "forward".
        Without `params`, full-width synthetic weights are drawn on the
        device from a torch.Generator seeded with `seed` (fan-in rule,
        `models.layers.fan_in_init_`), with a seeded rank-`lora_rank`
        reverse LoRA merged into the UNet by `merge_lora`."""
        device = resolve_device(device)
        unet_cfg = unet_cfg or UNetConfig.sd15()
        clip_cfg = clip_cfg or CLIPTextConfig.vit_l()
        vae_cfg = vae_cfg or VAEConfig.sd()
        with torch.device(device):
            text = CLIPTextModel(clip_cfg)
            vae = AutoencoderKL(vae_cfg)
            names = ("reverse",) if params is None else [k for k in UNET_KEYS if k in params]
            unets = {name: UNet2DCondition(unet_cfg) for name in names}
        if params is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            for module in (unets["reverse"], text, vae):
                fan_in_init_(module, gen)
            base = unets["reverse"].state_dict()
            unets["reverse"].load_state_dict(
                merge_lora(base, seeded_lora(base, gen, lora_rank), rank=lora_rank)
            )
        else:
            text.load_state_dict(params["text"])
            vae.load_state_dict(params["vae"])
            for name, unet in unets.items():
                unet.load_state_dict(params[name])
        for module in (text, vae, *unets.values()):
            cast_compute_weights(module, dtype).eval().requires_grad_(False)
        return InvertibleCD(
            unets=unets,
            text_encoder=text,
            vae=vae,
            tokenizer=tokenizer or default_tokenizer(),
            schedule=make_schedule(device=device),
            grid=grid or make_solver_grid(
                reverse_timesteps=[259, 519, 779, 999],
                forward_timesteps=[19, 259, 519, 779],
            ),
            scaling_factor=vae_cfg.scaling_factor,
            latent_size=latent_size,
        )

    @property
    def device(self) -> torch.device:
        return self.vae.quant_conv.weight.device

    @property
    def w_embed_dim(self) -> int:
        """The UNets' guidance-embedding width (0 if not w-conditioned)."""
        unet = next(iter(self.unets.values()))
        return unet.cfg.time_cond_proj_dim or 0

    def default_guidance(self, **kw) -> S.GuidanceConfig:
        kw.setdefault("w_embed_dim", self.w_embed_dim)
        return S.GuidanceConfig(**kw)

    # ------------------------------------------------------------------
    # Text encoding
    # ------------------------------------------------------------------
    def _encode_tokens(self, prompts: Sequence[str]) -> torch.Tensor:
        tokens = torch.as_tensor(self.tokenizer(list(prompts)), dtype=torch.long)
        return self.text_encoder(tokens.to(self.device))["last_hidden_state"]

    @torch.inference_mode()
    def encode_prompt(self, prompts: Sequence[str]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(uncond_context, cond_context), each (B, 77, D)."""
        if isinstance(prompts, str):
            prompts = [prompts]
        return self._encode_tokens([""] * len(prompts)), self._encode_tokens(prompts)

    @torch.inference_mode()
    def _encode_all(self, prompts: Sequence[str], need_uncond: bool = True):
        """(ctx_uncond, ctx_cond). `need_uncond=False` skips the "" CLIP
        pass: the w-conditioned sampler never reads the uncond context."""
        if need_uncond:
            return self.encode_prompt(prompts)
        ctx_c = self._encode_tokens(prompts)
        return ctx_c, ctx_c

    # ------------------------------------------------------------------
    # Model calls
    # ------------------------------------------------------------------
    def _noise_model(self, unet: UNet2DCondition):
        def nm(latent, t, context, w_emb):
            b = latent.shape[0]
            return unet(
                latent, torch.full((b,), t, dtype=torch.long, device=latent.device),
                context, w_cond=w_emb,
            )
        return nm

    def _decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """latents (B, 4, h, w) scaled -> images (B, H, W, 3) fp32 in [0, 1]."""
        img = self.vae.decode(latents / self.scaling_factor)
        img = torch.clamp(img.float() / 2 + 0.5, 0.0, 1.0)
        return img.permute(0, 2, 3, 1).contiguous()

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------
    def init_latent(
        self, generator: Optional[torch.Generator], batch: int, dtype=torch.float32
    ) -> torch.Tensor:
        """One shared (1, h, w, 4) NHWC latent expanded across the batch."""
        h, w = self.latent_size
        z = torch.randn((1, h, w, 4), generator=generator, device=self.device, dtype=dtype)
        return z.expand(batch, h, w, 4)

    @torch.inference_mode()
    def generate(
        self,
        prompts: Sequence[str],
        generator: Optional[torch.Generator] = None,
        latent: Optional[torch.Tensor] = None,
        guidance: Optional[S.GuidanceConfig] = None,
        model: str = "reverse",
    ):
        """Few-step consistency generation.

        `latent`: optional (B, h, w, 4) NHWC start latent (any device; numpy
        accepted); otherwise one latent drawn from `generator` (seed 0 when
        None) is shared by the batch. Returns (images (B, H, W, 3) float32 in
        [0, 1] NHWC, final latents (B, h, w, 4) NHWC), both on the device.
        """
        if isinstance(prompts, str):
            prompts = [prompts]
        g = guidance or self.default_guidance()
        ctx_u, ctx_c = self._encode_all(prompts, need_uncond=g.w_embed_dim <= 0)
        if latent is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            latent = self.init_latent(generator, len(prompts))
        latent = torch.as_tensor(latent, dtype=torch.float32, device=self.device)
        lat = S.cons_generation(
            self._noise_model(self.unets[model]), latent.permute(0, 3, 1, 2),
            ctx_u, ctx_c, self.grid, self.schedule, g,
        )
        return self._decode_latents(lat), lat.permute(0, 2, 3, 1).contiguous()


def to_uint8(images) -> np.ndarray:
    """float [0,1] images (tensor or array) -> uint8 numpy."""
    if isinstance(images, torch.Tensor):
        images = images.detach().cpu().numpy()
    arr = np.asarray(images)
    return np.round(np.clip(arr, 0, 1) * 255).astype(np.uint8)
