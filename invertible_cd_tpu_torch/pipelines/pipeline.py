"""InvertibleCD — the user-facing pipeline bundling the UNet students, CLIP and VAE.

PyTorch counterpart of `invertible_cd_tpu/pipelines/pipeline.py` for the
consistency paths:

  generate():  CLIP encode -> 4 reverse consistency hops -> VAE decode and clamp
  invert():    VAE encode -> 4 forward consistency hops (the forward student)
  edit():      invert() under the source prompt, then generate() on the
               [source, target] pair with a prompt-to-prompt controller
  ddim_generate(), ddim_invert():  the 50-step DDIM baselines with the
               teacher (CFG; per-step null-text contexts from `nti.py`)
  collect_quant_stats():  calibrates the "int8_static" convolution scales

`quantize` selects int8 inference (`ops/quant.py`): "off"; "int8" (every
UNet and VAE dense and convolution layer through kernel Q1); "int8_vae" (the
VAE only: the latents are those of "off"); "int8_static" (as "int8", the
convolutions with calibrated activation scales where `quant_stats` has
them). CLIP is never quantised. It is read at every call, so assigning it
switches the mode.

Public functions keep the JAX package's layouts: latents (B, 64, 64, 4)
NHWC in and out, images (B, 512, 512, 3) float32 in [0, 1] NHWC out. Inside,
the models run NCHW. SDXL's pipeline (`pipelines/sdxl.py`) subclasses this
one.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..diffusion.schedule import NoiseSchedule, make_schedule
from ..diffusion.solver import SolverGrid, make_solver_grid
from ..edit.controllers import ControllerArrays, ControllerRuntime, ControllerSpec
from ..models.clip import CLIPTextConfig, CLIPTextModel
from ..models.layers import cast_compute_weights, fan_in_init_
from ..models.lora import merge_lora, seeded_lora
from ..models.unet2d import UNet2DCondition, UNetConfig
from ..models.vae import AutoencoderKL, VAEConfig
from ..ops.quant import quant_scope
from ..parallel.mesh import Mesh, gather_rows, latent_rows
from ..parallel.spatial import check_height as spatial_check_height
from ..parallel.spatial import spatial
from ..utils.tokenizer import default_tokenizer
from . import sampler as S

UNET_KEYS = ("teacher", "reverse", "forward")
QUANT_MODES = ("off", "int8", "int8_vae", "int8_static")


def check_quantize(quantize: str) -> str:
    if quantize not in QUANT_MODES:
        raise ValueError(f"quantize={quantize!r}; expected one of {QUANT_MODES}")
    return quantize


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; a CUDA device must exist (pass
    device="cpu" to run on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


def _under_spatial(noise_model, mesh: Mesh):
    """`noise_model` with each call under `spatial(mesh)` (on this rank's
    rows of the height)."""
    def call(*args, **kwargs):
        with spatial(mesh):
            return noise_model(*args, **kwargs)
    return call


@dataclasses.dataclass
class InvertibleCD:
    """UNet student(s) + CLIP text encoder + VAE on one device.

    `unets` maps a model name ("reverse" and "forward", the students;
    "teacher", the base the DDIM baselines run) to its UNet, with any LoRA
    already merged into the weights."""

    unets: Dict[str, UNet2DCondition]
    text_encoder: CLIPTextModel
    vae: AutoencoderKL
    tokenizer: object
    schedule: NoiseSchedule
    grid: SolverGrid
    scaling_factor: float = 0.18215
    latent_size: Tuple[int, int] = (64, 64)
    #: int8 inference mode, one of QUANT_MODES (JAX `pipeline.py:63-80`)
    quantize: str = "off"
    #: "int8_static"'s calibrated conv-input amaxes, per model ("reverse",
    #: "forward", "vae"): {module name: fp32 scalar}, kept outside the state
    #: dicts (`collect_quant_stats`)
    quant_stats: Dict[str, Dict[str, torch.Tensor]] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        check_quantize(self.quantize)

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
        quantize: str = "off",
    ) -> "InvertibleCD":
        """SD1.5 bundle on `device`, computing in `dtype`: the modules of
        `build_modules`, from `params` ("text", "vae" and one or more of
        "teacher", "reverse", "forward"; diffusers / transformers keys) or,
        without it, from seeded full-width synthetic weights with seeded
        rank-`lora_rank` LoRAs merged into the two students (the teacher
        is the unmerged base). `quantize`: the int8 mode (QUANT_MODES)."""
        device = resolve_device(device)
        unet_cfg = unet_cfg or UNetConfig.sd15()
        vae_cfg = vae_cfg or VAEConfig.sd()
        unets, texts, vae = build_modules(
            params, device, seed, lora_rank, unet_cfg,
            {"text": clip_cfg or CLIPTextConfig.vit_l()}, vae_cfg, dtype, dtype,
        )
        return InvertibleCD(
            unets=unets,
            text_encoder=texts["text"],
            vae=vae,
            tokenizer=tokenizer or default_tokenizer(),
            schedule=make_schedule(device=device),
            grid=grid or make_solver_grid(
                reverse_timesteps=[259, 519, 779, 999],
                forward_timesteps=[19, 259, 519, 779],
            ),
            scaling_factor=vae_cfg.scaling_factor,
            latent_size=latent_size,
            quantize=quantize,
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
        """(ctx_uncond, ctx_cond, added_cond): SD1.5 has no added
        conditioning (None); the SDXL pipeline overrides this to supply its
        pooled-text and time-id conditioning. `need_uncond=False` skips the
        "" CLIP pass: the w-conditioned sampler never reads the uncond
        context."""
        if need_uncond:
            return (*self.encode_prompt(prompts), None)
        ctx_c = self._encode_tokens(prompts)
        return ctx_c, ctx_c, None

    # ------------------------------------------------------------------
    # Model calls
    # ------------------------------------------------------------------
    def _unet_quant_mode(self) -> str:
        return self.quantize if check_quantize(self.quantize) in ("int8", "int8_static") else "off"

    def _vae_quant_mode(self) -> str:
        if check_quantize(self.quantize) == "int8_static":
            return "int8_static"
        return "int8" if self.quantize in ("int8", "int8_vae") else "off"

    def _quant_scope(self, mode: str, name: Optional[str], module: torch.nn.Module):
        """The quantisation scope of one model call: `mode`, with the
        calibrated stats of model `name` under "int8_static"."""
        stats = self.quant_stats.get(name) if mode == "int8_static" else None
        return quant_scope(mode, stats, root=module if stats else None)

    def _noise_model(self, unet: UNet2DCondition, added: Optional[dict] = None,
                     quantized: bool = True):
        """The sampler's noise model over `unet`, with SDXL's added
        conditioning broadcast to the batch of each call (JAX
        `pipeline.py:190-219`): a call on a doubled CFG batch [uncond; cond]
        gives the uncond half zero text embeds (the reference zeroes the
        uncond pooled embeds) and every half the time ids. Each call runs in
        the UNet's quantisation scope for `quantize` (read at the call), or
        in "off" when not `quantized` (NTI's optimisation, as in JAX)."""
        name = next((k for k, u in self.unets.items() if u is unet), None)

        def nm(latent, t, context, w_emb, hook=None):
            b = latent.shape[0]
            added_b = added
            if added is not None and b > added["text_embeds"].shape[0]:
                te = added["text_embeds"]
                rep = b // te.shape[0]
                added_b = {"text_embeds": torch.cat([torch.zeros_like(te)] * (rep - 1) + [te]),
                           "time_ids": torch.cat([added["time_ids"]] * rep)}
            with self._quant_scope(self._unet_quant_mode() if quantized else "off", name, unet):
                return unet(
                    latent, torch.full((b,), t, dtype=torch.long, device=latent.device),
                    context, w_cond=w_emb, added_cond=added_b, attn_hook=hook,
                )
        return nm

    def _decode_latents(self, latents: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
        """latents (B, 4, h, w) scaled -> images (B, H, W, 3) fp32 in [0, 1],
        in the VAE's quantisation scope. With an sp `mesh`, `latents` are
        this rank's rows: the decode runs under `spatial(mesh)` and the
        image rows are gathered over the sp group."""
        with self._quant_scope(self._vae_quant_mode(), "vae", self.vae), spatial(mesh):
            img = self.vae.decode(latents / self.scaling_factor)
        img = torch.clamp(img.float() / 2 + 0.5, 0.0, 1.0)
        if mesh is not None:
            img = gather_rows(img, mesh)
        return img.permute(0, 2, 3, 1).contiguous()

    def _encode_image(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels (B, H, W, 3) in [-1, 1] -> scaled posterior-mean latents
        (B, 4, h, w) fp32 (JAX `pipeline.py:238-241`), in the VAE's
        quantisation scope."""
        with self._quant_scope(self._vae_quant_mode(), "vae", self.vae):
            mean = self.vae.encode_mean(pixels.permute(0, 3, 1, 2))
        return mean.float() * self.scaling_factor

    def _as_nchw(self, latent) -> torch.Tensor:
        """An NHWC latent (tensor on any device, or numpy) -> NCHW fp32 on the device."""
        if isinstance(latent, np.ndarray):
            latent = np.array(latent, dtype=np.float32)  # writable (a broadcast view is not)
        latent = torch.as_tensor(latent, dtype=torch.float32, device=self.device)
        return latent.permute(0, 3, 1, 2)

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
        controller: Optional[Tuple[ControllerSpec, ControllerArrays]] = None,
        model: str = "reverse",
        amplify_prompt: Optional[Sequence[str]] = None,
        return_trajectory: bool = False,
        mesh: Optional[Mesh] = None,
    ):
        """Few-step consistency generation (JAX `pipeline.py:312-363`).

        `latent`: optional (B, h, w, 4) NHWC start latent (any device; numpy
        accepted); otherwise one latent drawn from `generator` (seed 0 when
        None) is shared by the batch. `controller`: a (spec, arrays) pair
        from `edit.make_controller`, whose hooks edit attention and whose
        step callback blends latents. `amplify_prompt`: the prompt(s) whose
        context replaces the prompts' while `t > tau1 * 1000` under dynamic
        guidance.

        Returns (images (B, H, W, 3) float32 in [0, 1] NHWC, final latents
        (B, h, w, 4) NHWC), both on the device; with `return_trajectory`
        the latents are the (n_hops+1, B, h, w, 4) trajectory, row i hop i's
        input; with a `store_all` controller the attention store
        ({store_key: [(B, H, Sq, Sk) per hooked layer and hop]}) comes third.

        `mesh`: a `parallel.Mesh` with sp > 1 (every rank of its sp group
        calls with the same arguments) splits each latent's height over the
        group, as JAX's `latent_sharding` does: every rank draws (or is
        given) the whole latent, as one process does, and keeps its rows;
        the UNet calls and the decode run under `spatial(mesh)`, the hops on
        the rows; the images and latents come back whole on every rank of
        the group. A controller is refused there (its hooks read whole
        query rows). A mesh with sp = 1 changes nothing.
        """
        if isinstance(prompts, str):
            prompts = [prompts]
        sp_mesh = mesh if mesh is not None and mesh.sp > 1 else None
        if sp_mesh is not None:
            spatial_check_height(self.latent_size[0], sp_mesh.sp,
                                 len(next(iter(self.unets.values())).cfg.block_out_channels))
            if controller is not None:
                raise ValueError("a controller is refused under sp: its attention hooks read whole "
                                 "query rows, and each sp rank holds only its rows")
        g = guidance or self.default_guidance()
        ctx_u, ctx_c, added = self._encode_all(prompts, need_uncond=g.w_embed_dim <= 0)
        ctx_amp = None
        if amplify_prompt is not None:
            amplify_prompt = [amplify_prompt] if isinstance(amplify_prompt, str) else list(amplify_prompt)
            if len(amplify_prompt) == 1 and len(prompts) > 1:
                amplify_prompt = amplify_prompt * len(prompts)
            ctx_amp = self._encode_all(amplify_prompt, need_uncond=False)[1]
        if latent is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            latent = self.init_latent(generator, len(prompts))
        spec, arrays = controller if controller else (None, None)
        rt = ControllerRuntime(spec, arrays.to(self.device)) if spec is not None else None
        noise_model = self._noise_model(self.unets[model], added)
        if sp_mesh is not None:
            noise_model = _under_spatial(noise_model, sp_mesh)
        lat = S.cons_generation(
            noise_model,
            latent_rows(self._as_nchw(latent), sp_mesh) if sp_mesh else self._as_nchw(latent),
            ctx_u, ctx_c, self.grid, self.schedule, g,
            hook_factory=rt.hook_factory if rt else None,
            step_callback=rt.step_callback if rt else None,
            context_amplify=ctx_amp,
            return_all=return_trajectory,
        )
        final = lat[-1].permute(0, 3, 1, 2) if return_trajectory else lat
        if sp_mesh is None:
            images = self._decode_latents(final)
        else:
            images = self._decode_latents(final, sp_mesh)
            lat = gather_rows(lat, sp_mesh, 2)  # height: axis 2 of the NHWC trajectory and of NCHW
        if not return_trajectory:
            lat = lat.permute(0, 2, 3, 1).contiguous()
        if spec is not None and spec.store_all:
            return images, lat, rt.store
        return images, lat

    @torch.inference_mode()
    def invert(
        self,
        image,
        prompt="",
        generator: Optional[torch.Generator] = None,
        noise=None,
        guidance: Optional[S.GuidanceConfig] = None,
        return_trajectory: bool = False,
    ):
        """Forward-CD inversion of a real image (JAX `pipeline.py:365-403`).

        `image`: (H, W, 3) or (B, H, W, 3) uint8/float in [0, 255] (numpy or
        tensor). `prompt`: one string shared by the batch, or one per image.
        `noise`: the (B, h, w, 4) NHWC start-timestep noise; otherwise drawn
        from `generator` (seed 0 when None). The forward student is
        w-conditioned and trained at w = 0, so the default guidance keeps
        the w-embedding at w = 0 rather than dropping it.

        Returns (noise latent (B, h, w, 4), clean latent (B, h, w, 4)), NHWC
        on the device; `return_trajectory` replaces the noise latent with
        the (n_hops+1, B, h, w, 4) forward trajectory."""
        pixels = to_model_pixels(image).to(self.device)
        g = guidance or self.default_guidance(guidance_scale=0.0)
        prompts = [prompt] * pixels.shape[0] if isinstance(prompt, str) else list(prompt)
        ctx_u, ctx_c, added = self._encode_all(prompts, need_uncond=g.w_embed_dim <= 0)
        if noise is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            h, w = self.latent_size
            noise = torch.randn((pixels.shape[0], h, w, 4), generator=generator, device=self.device)
        latent = self._encode_image(pixels)
        inv = S.cons_inversion(
            self._noise_model(self.unets["forward"], added), latent, self._as_nchw(noise),
            ctx_u, ctx_c, self.grid, self.schedule, g, return_all=return_trajectory,
        )
        if not return_trajectory:
            inv = inv.permute(0, 2, 3, 1).contiguous()
        return inv, latent.permute(0, 2, 3, 1).contiguous()

    def edit(
        self,
        image,
        source_prompt: str,
        target_prompt: str,
        controller: Tuple[ControllerSpec, ControllerArrays],
        generator: Optional[torch.Generator] = None,
        guidance: Optional[S.GuidanceConfig] = None,
        invert_guidance: Optional[S.GuidanceConfig] = None,
        noise=None,
    ):
        """Invert-then-edit (JAX `pipeline.py:405-430`): forward CD encodes
        the image under the source prompt, then reverse CD decodes the
        [source, target] pair with the controller mixing attention; row 1 is
        the edited image. Default guidance: w = 19, dynamic with tau1 = tau2
        = 0.8, the w-embedding on the target row only (`edit_pair`).
        `generator` / `noise` go to `invert`.

        Returns `generate`'s result: (images (2, H, W, 3), latents (2, h, w,
        4)), plus the store for a `store_all` controller."""
        inv, _ = self.invert(image, source_prompt, generator=generator, noise=noise,
                             guidance=invert_guidance)
        latent = inv[:1].expand((2,) + tuple(inv.shape[1:]))
        g = guidance or self.default_guidance(
            guidance_scale=19.0, dynamic_guidance=True, tau1=0.8, tau2=0.8, edit_pair=True,
        )
        return self.generate(
            [source_prompt, target_prompt], latent=latent, guidance=g, controller=controller,
        )

    @torch.no_grad()
    def ddim_generate(
        self,
        prompts: Sequence[str],
        generator: Optional[torch.Generator] = None,
        latent: Optional[torch.Tensor] = None,
        guidance: Optional[S.GuidanceConfig] = None,
        controller: Optional[Tuple[ControllerSpec, ControllerArrays]] = None,
        nti_uncond=None,
        model: str = "teacher",
    ):
        """The 50-step DDIM baseline generation (JAX `pipeline.py:432-461`):
        `grid.n_steps` DDIM steps of `model` (default the teacher) under
        CFG 7.5 without the w-embedding, then the VAE decode.

        `latent` and `generator` as in `generate`; `controller` a (spec,
        arrays) pair made with `num_steps=grid.n_steps`; `nti_uncond` the
        (n_steps, B, 77, D) per-step uncond contexts of
        `pipelines.nti.null_text_inversion` or `negative_prompt_inversion`.
        Gradient-free, not inference mode, so that its results can enter an
        optimisation.

        Returns (images (B, H, W, 3) float32 in [0, 1], final latents (B,
        h, w, 4) NHWC); with a `store_all` controller the store
        ({store_key: [one step-averaged (B, H, Sq, Sk) map per hooked
        layer]}) comes third."""
        if isinstance(prompts, str):
            prompts = [prompts]
        g = guidance or S.GuidanceConfig(guidance_scale=7.5, w_embed_dim=0)
        ctx_u, ctx_c, added = self._encode_all(prompts)
        if latent is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            latent = self.init_latent(generator, len(prompts))
        if nti_uncond is not None:
            nti_uncond = torch.as_tensor(nti_uncond, device=self.device).to(ctx_c.dtype)
        spec, arrays = controller if controller else (None, None)
        rt = ControllerRuntime(spec, arrays.to(self.device)) if spec is not None else None
        lat = S.ddim_loop(
            self._noise_model(self.unets[model], added), self._as_nchw(latent),
            ctx_u, ctx_c, self.grid, self.schedule, g, is_forward=False,
            per_step_uncond=nti_uncond,
            hook_factory=rt.hook_factory if rt else None,
            step_callback=rt.step_callback if rt else None,
        )
        images = self._decode_latents(lat)
        lat = lat.permute(0, 2, 3, 1).contiguous()
        if spec is not None and spec.store_all:
            return images, lat, rt.store
        return images, lat

    @torch.no_grad()
    def ddim_invert(self, image, prompt="", guidance: Optional[S.GuidanceConfig] = None):
        """The 50-step DDIM inversion of a real image with the teacher (JAX
        `pipeline.py:463-482`), CFG 1.0 by default. `image` and `prompt` as
        in `invert`.

        Returns (the (n_steps+1, B, h, w, 4) NHWC trajectory, t ascending:
        row 0 the clean latent, the last row the inverted latent that NTI
        and `ddim_generate` start from; the clean latent (B, h, w, 4))."""
        pixels = to_model_pixels(image).to(self.device)
        g = guidance or S.GuidanceConfig(guidance_scale=1.0, w_embed_dim=0)
        prompts = [prompt] * pixels.shape[0] if isinstance(prompt, str) else list(prompt)
        ctx_u, ctx_c, added = self._encode_all(prompts)
        latent = self._encode_image(pixels)
        traj = S.ddim_loop(
            self._noise_model(self.unets["teacher"], added), latent, ctx_u, ctx_c,
            self.grid, self.schedule, g, is_forward=True, return_all=True,
        )
        return traj, latent.permute(0, 2, 3, 1).contiguous()

    @torch.inference_mode()
    def collect_quant_stats(
        self,
        prompts: Sequence[str] = ("a photo of a corgi on the beach",),
        generator: Optional[torch.Generator] = None,
        models: Sequence[str] = ("reverse", "forward"),
        guidance: Optional[S.GuidanceConfig] = None,
        latent=None,
        noise=None,
    ) -> None:
        """Calibrate the "int8_static" convolution scales (JAX
        `pipeline.py:484-600`) into `quant_stats`.

        An "off" reference run records the true per-hop inputs: `generate`'s
        reverse trajectory from `latent` (else drawn from `generator`, seed
        0 when None) and, for the forward student, the `invert` trajectory
        of its images at w = 0 (its noise `noise`, else drawn from the same
        generator). Each student then runs once a hop on exactly those
        latents (cast to bf16 first, with a bf16 w-embedding, as JAX does)
        under `quant_scope("calibrate")`, which records the running max of
        |input| per convolution; the VAE decodes the final latent and
        encodes the decoded pixels (clipped to [-1, 1]), one stats dict for
        both. Each model's stats replace its old ones; the "off" path never
        reads them."""
        from ..diffusion.guidance import guidance_scale_embedding

        prompts = list(prompts)
        b = len(prompts)
        g = guidance or self.default_guidance()
        _, ctx_c, added = self._encode_all(prompts, need_uncond=False)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        old = self.quantize
        self.quantize = "off"
        try:
            images, traj = self.generate(prompts, generator=generator, latent=latent, guidance=g,
                                         return_trajectory=True)
            inv_traj = None
            if "forward" in models:
                inv_traj, _ = self.invert(
                    images * 255.0, prompts, generator=generator, noise=noise,
                    guidance=self.default_guidance(guidance_scale=0.0), return_trajectory=True)
        finally:
            self.quantize = old

        def w_embedding(scale: float):
            if not g.w_embed_dim:
                return None
            return guidance_scale_embedding(
                torch.full((b,), scale, dtype=torch.float32, device=self.device),
                g.w_embed_dim, dtype=torch.bfloat16)

        for model in models:
            if model == "forward":
                grid_ts, hop_inputs, w = self.grid.forward_timesteps, inv_traj, w_embedding(0.0)
            else:
                grid_ts, hop_inputs, w = self.grid.reverse_timesteps, traj, w_embedding(g.guidance_scale)
            unet, stats = self.unets[model], {}
            with quant_scope("calibrate", stats, root=unet):
                for i, t in enumerate(grid_ts):
                    lat = hop_inputs[i].to(torch.bfloat16).permute(0, 3, 1, 2)
                    unet(lat, torch.full((b,), int(t), dtype=torch.long, device=self.device),
                         ctx_c, w_cond=w, added_cond=added)
            self.quant_stats[model] = stats

        stats = {}
        with quant_scope("calibrate", stats, root=self.vae):
            img = self.vae.decode(traj[-1].float().permute(0, 3, 1, 2) / self.scaling_factor)
            self.vae.encode_mean(torch.clamp(img.float(), -1.0, 1.0))
        self.quant_stats["vae"] = stats

    @torch.inference_mode()
    def decode(self, latents) -> np.ndarray:
        """(B, h, w, 4) NHWC scaled latents -> images (B, H, W, 3) float32
        numpy in [0, 1] (JAX `pipeline.py:604-606`)."""
        return self._decode_latents(self._as_nchw(latents)).cpu().numpy()


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------
def build_modules(
    params: Optional[Dict[str, Dict[str, torch.Tensor]]],
    device: torch.device,
    seed: int,
    lora_rank: int,
    unet_cfg: UNetConfig,
    text_cfgs: Dict[str, CLIPTextConfig],
    vae_cfg: VAEConfig,
    dtype,
    vae_dtype,
):
    """A bundle's modules on `device`: (UNets by name, text encoders by
    name, VAE), the UNets and text encoders computing in `dtype`, the VAE in
    `vae_dtype` (norms stay fp32).

    `params` holds state dicts under the names of `text_cfgs`, "vae" and
    one or more of "teacher", "reverse", "forward"; a UNet is built for each
    of those that `params` holds. The modules are built on the meta device
    and take the given tensors themselves (a non-contiguous one made
    contiguous), so where device, dtype and layout already match nothing is
    copied. Without `params`, full-width synthetic weights are drawn on the
    device from a torch.Generator seeded with `seed` (fan-in rule,
    `models.layers.fan_in_init_`): one UNet base, the text encoders in the
    order given, the VAE, then a seeded rank-`lora_rank` LoRA for the
    "reverse" student and, drawn after it, one for the "forward" student,
    each merged into its own copy of the base by `merge_lora`. The
    "teacher" is a copy of the base taken before the merges (no draws)."""
    with torch.device(device if params is None else "meta"):
        texts = {name: CLIPTextModel(cfg) for name, cfg in text_cfgs.items()}
        vae = AutoencoderKL(vae_cfg)
        names = ("reverse", "forward") if params is None else [
            k for k in UNET_KEYS if k in params]
        unets = {name: UNet2DCondition(unet_cfg) for name in names}
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        for module in (unets["reverse"], *texts.values(), vae):
            fan_in_init_(module, gen)
        unets = {"teacher": copy.deepcopy(unets["reverse"]), **unets}
        base = unets["reverse"].state_dict()  # the reverse UNet's own tensors
        loras = {name: seeded_lora(base, gen, lora_rank) for name in ("reverse", "forward")}
        # the forward student first: the reverse merge writes into `base`
        for name in ("forward", "reverse"):
            unets[name].load_state_dict(merge_lora(base, loras[name], rank=lora_rank))
    else:
        for name, module in (*texts.items(), ("vae", vae), *unets.items()):
            state = {k: v.contiguous() for k, v in params[name].items()}
            module.load_state_dict(state, assign=True)
            module.to(device)
    for module in (*texts.values(), *unets.values()):
        cast_compute_weights(module, dtype).eval().requires_grad_(False)
    cast_compute_weights(vae, vae_dtype).eval().requires_grad_(False)
    return unets, texts, vae


def to_model_pixels(image) -> torch.Tensor:
    """uint8/float [0, 255] (B, H, W, 3) or (H, W, 3), numpy or tensor ->
    float32 [-1, 1] NHWC tensor on the input's device (JAX
    `pipeline.py:615`)."""
    arr = torch.as_tensor(np.asarray(image) if not isinstance(image, torch.Tensor) else image)
    if arr.dim() == 3:
        arr = arr[None]
    return arr.to(torch.float32) / 127.5 - 1.0


def load_512(image, left=0, right=0, top=0, bottom=0, size=512) -> np.ndarray:
    """Load an image (path, PIL image or HWC array), apply optional edge-crop
    offsets and a center square crop, and resize it to (size, size) uint8
    RGB (JAX `pipeline.py:623`). With default offsets this is a plain
    resize, as the reference's active code is; nonzero offsets clamp as the
    reference does, `top` against `left`. PIL is imported here only."""
    from PIL import Image

    if isinstance(image, str):
        arr = np.array(Image.open(image).convert("RGB"))[:, :, :3]
    elif isinstance(image, Image.Image):
        arr = np.array(image.convert("RGB"))[:, :, :3]
    else:
        arr = np.asarray(image)[:, :, :3]
    if left or right or top or bottom:
        h, w, _ = arr.shape
        left = min(left, w - 1)
        right = min(right, w - left - 1)
        top = min(top, h - left - 1)  # the reference clamps top against left
        bottom = min(bottom, h - top - 1)
        arr = arr[top:h - bottom, left:w - right]
        h, w, _ = arr.shape
        if h < w:
            offset = (w - h) // 2
            arr = arr[:, offset:offset + h]
        elif w < h:
            offset = (h - w) // 2
            arr = arr[offset:offset + w]
    out = Image.fromarray(arr.astype(np.uint8)).resize((size, size), Image.BICUBIC)
    return np.array(out)


def to_uint8(images) -> np.ndarray:
    """float [0,1] images (tensor or array) -> uint8 numpy."""
    if isinstance(images, torch.Tensor):
        images = images.detach().cpu().numpy()
    arr = np.asarray(images)
    return np.round(np.clip(arr, 0, 1) * 255).astype(np.uint8)
