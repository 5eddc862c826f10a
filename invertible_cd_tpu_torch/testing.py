"""Tiny bundles for tests: the real module code paths at miniature configs.

`tiny_configs()` and `tiny_configs_xl()` are the counterparts of the JAX
package's `invertible_cd_tpu.testing.tiny_bundle` and `tiny_bundle_xl`
configs, and `tiny_bundle` / `tiny_bundle_xl` build the PyTorch pipelines
from state dicts (for instance the JAX tiny bundles' params passed through
`models.convert.bundle_state_dicts_from_flax`). `published_state_dicts`
and `write_scorer_files` give the metric suite seeded weights in the
published checkpoints' formats, for the CLIs' `--calc_metrics` flags.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .diffusion.solver import make_solver_grid
from .models.clip import CLIPTextConfig
from .models.unet2d import UNetConfig
from .models.vae import VAEConfig
from .pipelines.pipeline import InvertibleCD
from .pipelines.sdxl import InvertibleCDXL
from .utils.tokenizer import HashTokenizer


def tiny_configs() -> Tuple[UNetConfig, CLIPTextConfig, VAEConfig]:
    return UNetConfig.tiny(), CLIPTextConfig.tiny(), VAEConfig.tiny()


def tiny_bundle(
    state_dicts: Optional[Dict[str, Dict[str, torch.Tensor]]],
    latent_size: Tuple[int, int] = (16, 16),
    dtype=torch.float32,
    device="cpu",
) -> InvertibleCD:
    """A miniature InvertibleCD from state dicts keyed "text", "vae" and
    any of "teacher", "reverse", "forward", or, for None, from seeded
    weights (seed 0, rank-4 LoRAs; `InvertibleCD.sd15`). Pixels are 32x32
    (the tiny VAE downsamples 2x); the tokenizer is the hash tokenizer over
    the tiny CLIP vocabulary."""
    unet_cfg, clip_cfg, vae_cfg = tiny_configs()
    return InvertibleCD.sd15(
        params=state_dicts,
        lora_rank=4,
        tokenizer=HashTokenizer(vocab_size=clip_cfg.vocab_size),
        dtype=dtype,
        device=device,
        unet_cfg=unet_cfg,
        clip_cfg=clip_cfg,
        vae_cfg=vae_cfg,
        latent_size=latent_size,
    )


def tiny_configs_xl() -> Tuple[UNetConfig, CLIPTextConfig, CLIPTextConfig, VAEConfig]:
    """(UNet, text encoder 1, text encoder 2, VAE) of the JAX tiny SDXL
    bundle: SDXL's structure (no attention at level 0, transformer depth 2,
    linear projections, added conditioning from a 16-wide projected pooled
    embedding and 8-wide time-id features) at tiny widths."""
    unet_cfg = UNetConfig(
        block_out_channels=(32, 64),
        cross_attn_blocks=(False, True),
        layers_per_block=1,
        num_heads=(2, 2),
        transformer_depth=(1, 2),
        cross_attention_dim=64,
        use_linear_projection=True,
        time_cond_proj_dim=8,
        addition_embed_dim=16 + 6 * 8,
        addition_time_embed_dim=8,
    )
    clip2_cfg = CLIPTextConfig(
        vocab_size=1000, hidden_size=32, num_layers=2, num_heads=2,
        intermediate_size=64, projection_dim=16,
    )
    return unet_cfg, CLIPTextConfig.tiny(), clip2_cfg, VAEConfig.tiny()


def tiny_bundle_xl(
    state_dicts: Optional[Dict[str, Dict[str, torch.Tensor]]],
    latent_size: Tuple[int, int] = (16, 16),
    dtype=torch.float32,
    device="cpu",
) -> InvertibleCDXL:
    """A miniature InvertibleCDXL from state dicts keyed "text", "text_2",
    "vae" and any of "teacher", "reverse", "forward", or, for None, from
    seeded weights (seed 0, rank-4 LoRAs), with the JAX tiny bundle's
    settings: the VAE in `dtype` too, SD1.5's 4-hop grid, time ids at a
    32-pixel resolution, the hash tokenizer for both encoders."""
    unet_cfg, clip_cfg, clip2_cfg, vae_cfg = tiny_configs_xl()
    tok = HashTokenizer(vocab_size=clip_cfg.vocab_size)
    return InvertibleCDXL.sdxl(
        params=state_dicts, lora_rank=4, tokenizer=tok, tokenizer_2=tok, dtype=dtype, vae_dtype=dtype,
        device=device, unet_cfg=unet_cfg, clip_cfg=clip_cfg, clip2_cfg=clip2_cfg,
        vae_cfg=vae_cfg, latent_size=latent_size, default_resolution=32,
        grid=make_solver_grid(reverse_timesteps=[259, 519, 779, 999],
                              forward_timesteps=[19, 259, 519, 779]),
    )


# ---------------------------------------------------------------------------
# Seeded scorer checkpoints in the published formats
# ---------------------------------------------------------------------------
def _timm_vit_state(sd: Dict[str, torch.Tensor], prefix: str = "") -> Dict[str, torch.Tensor]:
    """`metrics.vit.ViTTrunk` keys -> a timm-style ViT's (torch-hub DINOv2,
    BLIP's visual encoder): the inverse of `convert._timm_vit`."""
    out, qkv = {}, {}
    for key, t in sd.items():
        if key == "class_embedding":
            out["cls_token"] = t.reshape(1, 1, -1)
        elif key == "position_embedding":
            out["pos_embed"] = t[None]
        elif key.startswith("patch_embed."):
            out["patch_embed.proj." + key.rpartition(".")[2]] = t
        elif key.startswith("post_layernorm."):
            out["norm." + key.rpartition(".")[2]] = t
        elif key.startswith("blocks."):
            _, layer, rest = key.split(".", 2)
            name, _, leaf = rest.partition(".")
            if name in ("q_proj", "k_proj", "v_proj"):
                qkv.setdefault((layer, leaf), {})[name] = t
            elif name == "out_proj":
                out[f"blocks.{layer}.attn.proj.{leaf}"] = t
            elif name in ("ls1", "ls2"):
                out[f"blocks.{layer}.{name}.gamma"] = t
            elif name in ("fc1", "fc2"):
                out[f"blocks.{layer}.mlp.{rest}"] = t
            else:
                out[f"blocks.{layer}.{rest}"] = t
    for (layer, leaf), parts in qkv.items():
        out[f"blocks.{layer}.attn.qkv.{leaf}"] = torch.cat(
            [parts["q_proj"], parts["k_proj"], parts["v_proj"]])
    return {prefix + k: v for k, v in out.items()}


def published_state_dicts(modules: Dict[str, torch.nn.Module]) -> Dict[str, Dict[str, torch.Tensor]]:
    """Each scorer module's state dict in its published checkpoint's format
    (the inverse of the converters in `models.convert`), keyed by the CLI
    flag that reads it: pytorch-fid's Inception, transformers' CLIP vision
    and text towers, torch-hub DINOv2, torchvision's VGG16 features and the
    LPIPS heads, and ImageReward-v1.0's checkpoint."""
    from .models.convert import _IR_MLP, _VGG_FEATURE_INDEX

    sd = {name: {k: v.detach().cpu().clone() for k, v in m.state_dict().items()}
          for name, m in modules.items()}
    vision = {}
    for key, t in sd["clip_vision"].items():
        if key == "class_embedding":
            vision["vision_model.embeddings.class_embedding"] = t
        elif key.startswith("patch_embed."):
            vision["vision_model.embeddings.patch_embedding." + key.rpartition(".")[2]] = t
        elif key == "position_embedding":
            vision["vision_model.embeddings.position_embedding.weight"] = t
        elif key.startswith("pre_layernorm."):
            vision["vision_model.pre_layrnorm." + key.rpartition(".")[2]] = t
        elif key.startswith("post_layernorm."):
            vision["vision_model." + key] = t
        elif key == "projection.weight":
            vision["visual_projection.weight"] = t
        else:
            _, layer, rest = key.split(".", 2)
            name = rest.partition(".")[0]
            sub = {"norm1": "layer_norm1", "norm2": "layer_norm2", "fc1": "mlp.fc1",
                   "fc2": "mlp.fc2"}.get(name, "self_attn." + name)
            vision[f"vision_model.encoder.layers.{layer}.{sub}{rest[len(name):]}"] = t
    vgg_index = {name: idx for idx, name in _VGG_FEATURE_INDEX.items()}
    vgg, heads = {}, {}
    for key, t in sd["lpips"].items():
        if key.startswith("vgg."):
            _, name, leaf = key.split(".")
            vgg[f"features.{vgg_index[name]}.{leaf}"] = t
        else:
            heads[key.replace(".weight", ".model.1.weight")] = t
    ir_mlp = {fc: idx for idx, fc in _IR_MLP.items()}
    ir = {}
    for key, t in sd["image_reward"].items():
        top, rest = key.split(".", 1)
        if top == "mlp":
            fc, leaf = rest.split(".")
            ir[f"mlp.layers.{ir_mlp[fc]}.{leaf}"] = t
        elif top == "text_encoder":
            if rest == "word_embeddings.weight":
                ir["blip.text_encoder.embeddings.word_embeddings.weight"] = t
            elif rest == "position_embeddings":
                ir["blip.text_encoder.embeddings.position_embeddings.weight"] = t
            elif rest.startswith("embed_norm."):
                ir["blip.text_encoder.embeddings.LayerNorm." + rest.rpartition(".")[2]] = t
            else:
                _, layer, sub = rest.split(".", 2)
                parts = sub.split(".")
                if parts[0] in ("attention", "crossattention"):
                    inner = {"output": "output.dense", "norm": "output.LayerNorm"}.get(
                        parts[1], "self." + parts[1])
                    sub = f"{parts[0]}.{inner}.{parts[2]}"
                else:
                    sub = {"intermediate": "intermediate.dense", "output": "output.dense",
                           "norm": "output.LayerNorm"}[parts[0]] + "." + parts[1]
                ir[f"blip.text_encoder.encoder.layer.{layer}.{sub}"] = t
    visual = {k[len("visual_encoder."):]: t for k, t in sd["image_reward"].items()
              if k.startswith("visual_encoder.")}
    ir.update(_timm_vit_state(visual, "blip.visual_encoder."))
    return {"inception_weights": sd["inception"], "clip_vision_weights": vision,
            "clip_text_scorer_weights": sd["clip_text"], "dino_weights": _timm_vit_state(sd["dino"]),
            "vgg_weights": vgg, "lpips_heads_weights": heads, "image_reward_weights": ir}


BERT_TEST_WORDS = ("a photo of the cat dog on beach red fox corgi portrait with and in at "
                   "##s ##ing , . ! big small blue green").split()


def write_scorer_files(out_dir: str, tiny: bool, seed: int = 0, device="cpu") -> Dict[str, str]:
    """Seeded scorer checkpoints (`metrics.scores.scorer_modules`,
    `published_state_dicts`) and a small BERT vocab.txt written under
    `out_dir`; returns {CLI flag name (without --): path}, the flags
    `--calc_metrics` reads."""
    import os

    from .metrics.scores import scorer_modules

    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for flag, sd in published_state_dicts(scorer_modules(tiny, seed, device)).items():
        paths[flag] = os.path.join(out_dir, f"{flag}.pt")
        torch.save(sd, paths[flag])
    paths["bert_vocab"] = os.path.join(out_dir, "vocab.txt")
    with open(paths["bert_vocab"], "w", encoding="utf-8") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", *BERT_TEST_WORDS]) + "\n")
    return paths
