"""SDXL pipeline: dual text encoders and added conditioning.

PyTorch counterpart of `invertible_cd_tpu/pipelines/sdxl.py`. What differs
from SD1.5 lives here:
  * two tokenizers and encoders (ViT-L and OpenCLIP bigG); the context is
    the concatenation of both encoders' PENULTIMATE hidden states (768 +
    1280 = 2048), and the uncond context is zeros, not an encoded "";
  * added conditioning: bigG's projected pooled embedding and the
    micro-conditioning time ids [orig_h, orig_w, crop_top, crop_left,
    target_h, target_w];
  * an fp32 VAE by default (`vae_dtype`; bf16 is an opt-in), while the
    UNets and text encoders compute in `dtype` (bf16 on the card): the VAE's
    mid-block attention then takes kernel B2's fp32 build;
  * 1024^2 images (128^2 latents), VAE scaling 0.13025, and the iCD-SDXL
    grids: reverse 249/499/699/999, forward 19/249/499/699.

The samplers are SD1.5's (`pipelines/sampler.py`); the added conditioning
reaches the UNet through the noise model (`InvertibleCD._noise_model`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..diffusion.schedule import make_schedule
from ..diffusion.solver import SolverGrid, make_solver_grid
from ..models.clip import CLIPTextConfig, CLIPTextModel
from ..models.unet2d import UNetConfig
from ..models.vae import VAEConfig
from ..utils.tokenizer import default_tokenizer
from .pipeline import InvertibleCD, build_modules, resolve_device


@dataclasses.dataclass
class InvertibleCDXL(InvertibleCD):
    """SDXL bundle: `InvertibleCD` plus the second text encoder (bigG) and
    its tokenizer; `default_resolution` is the time ids' image size."""

    text_encoder_2: Optional[CLIPTextModel] = None
    tokenizer_2: Optional[object] = None
    default_resolution: int = 1024

    @staticmethod
    def sdxl(
        params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
        tokenizer=None,
        tokenizer_2=None,
        grid: Optional[SolverGrid] = None,
        dtype=torch.bfloat16,
        vae_dtype=torch.float32,
        device="cuda",
        seed: int = 0,
        unet_cfg: Optional[UNetConfig] = None,
        clip_cfg: Optional[CLIPTextConfig] = None,
        clip2_cfg: Optional[CLIPTextConfig] = None,
        vae_cfg: Optional[VAEConfig] = None,
        latent_size: Tuple[int, int] = (128, 128),
        lora_rank: int = 64,
        default_resolution: int = 1024,
        quantize: str = "off",
    ) -> "InvertibleCDXL":
        """SDXL bundle on `device`: the modules of
        `pipeline.build_modules`, from `params` ("text", "text_2", "vae" and
        one or more of "teacher", "reverse", "forward"; diffusers /
        transformers keys) or, without it, from seeded full-width synthetic
        weights (UNet, ViT-L, bigG, VAE, in that order) with seeded
        rank-`lora_rank` LoRAs merged into the two students. The UNets and
        encoders compute in `dtype`, the VAE in `vae_dtype` (fp32: SDXL's
        decoder overflows in fp16, reference `generation_sdxl.py:465-466`;
        bf16 keeps fp32's exponent range and is the opt-in). The configs
        default to SDXL's; tests pass tiny ones. `quantize`: the int8 mode
        (`pipeline.QUANT_MODES`; the fp32 VAE's int8 layers write fp32)."""
        device = resolve_device(device)
        unet_cfg = unet_cfg or UNetConfig.sdxl()
        vae_cfg = vae_cfg or VAEConfig.sdxl()
        texts_cfg = {"text": clip_cfg or CLIPTextConfig.vit_l(),
                     "text_2": clip2_cfg or CLIPTextConfig.open_clip_big_g()}
        unets, texts, vae = build_modules(params, device, seed, lora_rank, unet_cfg, texts_cfg,
                                          vae_cfg, dtype, vae_dtype)
        return InvertibleCDXL(
            unets=unets,
            text_encoder=texts["text"],
            vae=vae,
            tokenizer=tokenizer or default_tokenizer(),
            schedule=make_schedule(device=device),
            # iCD-SDXL checkpoints train on these endpoints (reference
            # running/sdxl/README.md:4), not SD1.5's 259/519/779 grid
            grid=grid or make_solver_grid(
                reverse_timesteps=[249, 499, 699, 999],
                forward_timesteps=[19, 249, 499, 699],
            ),
            scaling_factor=vae_cfg.scaling_factor,
            latent_size=latent_size,
            text_encoder_2=texts["text_2"],
            # OpenCLIP pads with 0, not eot (reference tokenizer_2 config)
            tokenizer_2=tokenizer_2 or default_tokenizer(pad_token_id=0),
            default_resolution=default_resolution,
            quantize=quantize,
        )

    # ------------------------------------------------------------------
    # Conditioning
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def encode_prompt_xl(self, prompts: Sequence[str]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(context (B, 77, 2048), pooled (B, 1280)) for the prompts: both
        encoders' penultimate hidden states concatenated, and bigG's
        projected pooled embedding (reference `generation_sdxl.py:9-44`)."""
        if isinstance(prompts, str):
            prompts = [prompts]

        def tokens(tok):
            return torch.as_tensor(tok(list(prompts)), dtype=torch.long).to(self.device)
        out1 = self.text_encoder(tokens(self.tokenizer))
        out2 = self.text_encoder_2(tokens(self.tokenizer_2))
        ctx = torch.cat([out1["penultimate_hidden_state"], out2["penultimate_hidden_state"]], dim=-1)
        return ctx, out2["projected_pooled"]

    def add_time_ids(self, batch: int, original_size=None, crop=(0, 0),
                     target_size=None) -> torch.Tensor:
        """(batch, 6) fp32 [orig_h, orig_w, crop_top, crop_left, target_h,
        target_w] (reference `compute_embeddings`, `generation_sdxl.py:47-76`)."""
        r = self.default_resolution
        o = original_size or (r, r)
        t = target_size or (r, r)
        row = torch.tensor([o[0], o[1], crop[0], crop[1], t[0], t[1]], dtype=torch.float32,
                           device=self.device)
        return row.expand(batch, 6)

    def _encode_all(self, prompts: Sequence[str], need_uncond: bool = True):
        """(ctx_uncond, ctx_cond, added_cond). The uncond context is zeros,
        not a second encoder pass (diffusers' force_zeros_for_empty_prompt;
        the reference trains with zero uncond embeds,
        `train_icd_xl_lora.py:900-903`), so `need_uncond` costs nothing."""
        ctx_c, pooled = self.encode_prompt_xl(prompts)
        added = {"text_embeds": pooled, "time_ids": self.add_time_ids(len(prompts))}
        return torch.zeros_like(ctx_c), ctx_c, added

    def encode_prompt(self, prompts: Sequence[str]) -> Tuple[torch.Tensor, torch.Tensor]:
        ctx_u, ctx_c, _ = self._encode_all(prompts)
        return ctx_u, ctx_c

    # ------------------------------------------------------------------
    # Editing
    # ------------------------------------------------------------------
    def edit(
        self,
        image,
        source_prompt: str,
        target_prompt: str,
        controller=None,
        generator: Optional[torch.Generator] = None,
        guidance=None,
        invert_guidance=None,
        noise=None,
    ):
        """SDXL invert-then-edit. Without a controller, the reference's SDXL
        protocol (`running/sdxl/edit.py:201-234`): forward-CD inversion under
        the source prompt at w = 0, then the [source, target] pair sampled
        from the inverted latent under dynamic guidance (w = 19, tau1 = tau2
        = 0.7) with `amplify_prompt=[source]` (the source context replaces
        each row's while t > tau1 * 1000). With a controller, SD1.5's
        prompt-to-prompt path (`InvertibleCD.edit`), as in the JAX package.

        Returns (images (2, H, W, 3) float32 in [0, 1]: row 0 the
        reconstruction, row 1 the edit; latents (2, h, w, 4))."""
        if controller is not None:
            return super().edit(image, source_prompt, target_prompt, controller,
                                generator=generator, guidance=guidance,
                                invert_guidance=invert_guidance, noise=noise)
        inv, _ = self.invert(image, source_prompt, generator=generator, noise=noise,
                             guidance=invert_guidance)
        g = guidance or self.default_guidance(
            guidance_scale=19.0, dynamic_guidance=True, tau1=0.7, tau2=0.7,
        )
        latent = inv[:1].expand((2,) + tuple(inv.shape[1:]))
        return self.generate([source_prompt, target_prompt], latent=latent, guidance=g,
                             amplify_prompt=[source_prompt])
