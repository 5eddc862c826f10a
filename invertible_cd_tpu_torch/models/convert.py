"""Weights bridge: the JAX package's Flax param trees -> this package's state dicts.

Each function is the exact inverse of a converter in
`invertible_cd_tpu/models/convert.py` (`convert_unet_from_diffusers`,
`convert_vae_from_diffusers`, `convert_clip_text_from_transformers`): it
takes a Flax param tree whose leaves are numpy arrays (with or without the
outer {"params": ...} level) and returns a {key: torch.Tensor} state dict in
diffusers / transformers naming:

  * conv kernels HWIO -> OIHW, dense kernels (in, out) -> (out, in),
    norm `scale` -> `weight`, `embedding` -> `weight`;
  * the `GroupNorm_0` wrapper level is dropped;
  * indexed module names `name_N` -> `name.N` (`to_out_0` -> `to_out.0`);
  * the VAE's `downsamplers_0` conv -> `downsamplers.0.conv`;
  * CLIP's `token_embedding/embedding` -> `text_model.embeddings.token_embedding.weight`.

`bundle_state_dicts_from_flax` carries a whole JAX bundle's params dict
across (UNets, both text encoders, VAE), and `lora_from_flax` a JAX adapter
tree, with the same key renames.

Loading from disk (counterparts of the JAX module's loaders):
  * `load_torch_file` (JAX :357): `.pt`/`.bin` through `torch.load`, and
    `.safetensors` through a reader of the public format written here (no
    `safetensors` package is needed);
  * `convert_lora_from_kohya` (JAX :304) and `export_lora_to_kohya` (:339):
    kohya LoRA files <-> this package's adapter dicts (`models.lora`), whose
    layout is kohya's, so this is mostly key renaming.

The metric suite (`metrics/`), both directions:
  * `metric_state_dict_from_flax`: a JAX metric module's variables
    (Inception's params and batch_stats, the ViTs, LPIPS, ImageReward) ->
    the port module's state dict, by the rules above plus BatchNorm's
    `mean`/`var` -> `running_mean`/`running_var` and `blocks_N`/`layer_N` ->
    `blocks.N`/`layer.N`;
  * the published checkpoints -> the port's modules, counterparts of JAX
    :379 `convert_clip_vision_from_transformers`, :189
    `convert_clip_text_from_transformers` (the text scorer), :433
    `convert_inception_weights`, :466 `convert_dinov2_weights`, :520
    `convert_image_reward_weights` and :642 `convert_lpips_weights`. The
    port keeps torch layouts, so these rename keys (and split the fused qkv
    of the timm-style ViTs).
"""
from __future__ import annotations

import json
import re
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

# Flax module names that stand for an index into a diffusers ModuleList.
_INDEXED = (
    "down_blocks", "up_blocks", "resnets", "attentions", "transformer_blocks",
    "downsamplers", "upsamplers", "to_out", "net", "layers",
)


def _leaves(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _params(tree):
    return tree["params"] if "params" in tree else tree


def _module_name(part: str) -> str:
    head, _, idx = part.rpartition("_")
    if head in _INDEXED and idx.isdigit():
        return f"{head}.{idx}"
    return part


def _tensor(leaf: str, value: np.ndarray) -> Tuple[str, torch.Tensor]:
    if leaf == "kernel":
        # conv HWIO -> OIHW, dense (in, out) -> (out, in)
        value = np.transpose(value, (3, 2, 0, 1)) if value.ndim == 4 else value.T
    name = "weight" if leaf in ("kernel", "scale", "embedding") else leaf
    return name, torch.tensor(value)


def _diffusers_state_dict(tree, vae: bool) -> Dict[str, torch.Tensor]:
    out = {}
    for path, value in _leaves(_params(tree)):
        mods = [p for p in path[:-1] if p != "GroupNorm_0"]
        names = [_module_name(p) for p in mods]
        if vae and mods and mods[-1] == "downsamplers_0":
            names.append("conv")
        leaf, tensor = _tensor(path[-1], value)
        out[".".join(names + [leaf])] = tensor
    return out


def unet_state_dict_from_flax(tree) -> Dict[str, torch.Tensor]:
    """Flax UNet2DCondition params -> diffusers UNet2DConditionModel keys."""
    return _diffusers_state_dict(tree, vae=False)


def vae_state_dict_from_flax(tree) -> Dict[str, torch.Tensor]:
    """Flax AutoencoderKL params -> diffusers AutoencoderKL keys."""
    return _diffusers_state_dict(tree, vae=True)


def clip_state_dict_from_flax(tree) -> Dict[str, torch.Tensor]:
    """Flax CLIPTextModel params -> transformers CLIPTextModel keys."""
    out = {}
    for path, value in _leaves(_params(tree)):
        if path == ("position_embedding",):
            out["text_model.embeddings.position_embedding.weight"] = torch.tensor(value)
            continue
        leaf, tensor = _tensor(path[-1], value)
        head = path[0]
        if head == "token_embedding":
            key = "text_model.embeddings.token_embedding"
        elif head == "text_projection":
            key = "text_projection"
        elif head == "final_layer_norm":
            key = "text_model.final_layer_norm"
        else:  # layers_N/...
            layer = "text_model.encoder.layers." + head.rpartition("_")[2]
            sub = path[1:-1]
            if sub[0] == "self_attn":
                key = f"{layer}.self_attn.{sub[1]}"
            elif sub[0] in ("fc1", "fc2"):
                key = f"{layer}.mlp.{sub[0]}"
            else:  # layer_norm1 / layer_norm2
                key = f"{layer}.{sub[0]}"
        out[f"{key}.{leaf}"] = tensor
    return out


def bundle_state_dicts_from_flax(params) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX pipeline's params dict ({"teacher", "reverse", "forward",
    "text", "text_2", "vae"}: any of them, Flax trees of numpy arrays) ->
    the state dicts `InvertibleCD.sd15(params=...)` and
    `InvertibleCDXL.sdxl(params=...)` take, under the same names."""
    convert = {"text": clip_state_dict_from_flax, "text_2": clip_state_dict_from_flax,
               "vae": vae_state_dict_from_flax}
    return {name: convert.get(name, unet_state_dict_from_flax)(tree)
            for name, tree in params.items()}


def lora_from_flax(tree) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX package's UNet adapter tree -> this package's adapter dict.

    In: {"a/b/c/kernel": {"down": (in, r) | (kh, kw, in, r), "up": (r, out)}}
    with numpy leaves. Out: {state-dict key of the adapted weight: {"down":
    (r, in) | (r, in, kh, kw), "up": (out, r)}} (`models.lora` layout), keys
    renamed as `unet_state_dict_from_flax` renames them."""
    out = {}
    for name, ab in tree.items():
        path = [p for p in name.split("/") if p != "params"]
        if path[-1] != "kernel":
            raise ValueError(f"adapter path {name!r} does not end in 'kernel'")
        key = ".".join([_module_name(p) for p in path[:-1] if p != "GroupNorm_0"] + ["weight"])
        down, up = np.asarray(ab["down"]), np.asarray(ab["up"])
        down = np.transpose(down, (3, 2, 0, 1)) if down.ndim == 4 else down.T
        out[key] = {"down": torch.tensor(down), "up": torch.tensor(up.T)}
    return out


# ---------------------------------------------------------------------------
# Files on disk
# ---------------------------------------------------------------------------
_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


def _read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """The safetensors format: an 8-byte little-endian header length, a JSON
    header {name: {"dtype", "shape", "data_offsets": [begin, end]}} (plus an
    optional "__metadata__"), then the raw little-endian buffers, offsets
    counted from the end of the header. Each tensor is read straight into
    its own CPU buffer."""
    out = {}
    with open(path, "rb") as f:
        (n,) = np.frombuffer(f.read(8), dtype="<u8")
        header = json.loads(f.read(int(n)))
        start = 8 + int(n)
        header.pop("__metadata__", None)
        for name, info in sorted(header.items(), key=lambda kv: kv[1]["data_offsets"][0]):
            begin, end = info["data_offsets"]
            raw = torch.empty(end - begin, dtype=torch.uint8)
            f.seek(start + begin)
            if f.readinto(raw.numpy()) != end - begin:
                raise ValueError(f"{path}: tensor {name!r} runs past the end of the file")
            out[name] = raw.view(_SAFETENSORS_DTYPES[info["dtype"]]).reshape(info["shape"])
    return out


def load_torch_file(path: str) -> Dict[str, torch.Tensor]:
    """A `.safetensors`, `.pt` or `.bin` state dict -> flat {name: CPU
    tensor} (JAX `models/convert.py:357`); a `{"state_dict": ...}` wrapper
    is unwrapped."""
    if path.endswith(".safetensors"):
        return _read_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return dict(sd)


# ---------------------------------------------------------------------------
# Kohya LoRA
# ---------------------------------------------------------------------------
_KOHYA_RE = re.compile(r"^lora_unet_(.+?)\.(lora_down|lora_up|alpha)(?:\.weight)?$")
# the structural tokens of a kohya module name, tried in this order
_KOHYA_TOKENS = (
    "down_blocks", "up_blocks", "mid_block", "attentions",
    "transformer_blocks", "resnets", "downsamplers", "upsamplers",
    "attn1", "attn2", "to_q", "to_k", "to_v", "to_out_0",
    "proj_in", "proj_out", "ff_net_0_proj", "ff_net_2",
    "conv1", "conv2", "conv_shortcut", "conv", "time_emb_proj",
    "time_embedding", "linear_1", "linear_2", "cond_proj",
)
_KOHYA_INDEXED = (
    "down_blocks", "up_blocks", "attentions", "transformer_blocks", "resnets",
    "downsamplers", "upsamplers",
)
_KOHYA_SPLIT = {"ff_net_0_proj": ["ff", "net.0", "proj"], "ff_net_2": ["ff", "net.2"],
                "to_out_0": ["to_out.0"]}


def _kohya_module_to_key(module: str) -> str:
    """kohya's flat module name (the diffusers path joined with "_") -> the
    state-dict key of the adapted weight, e.g.
    `down_blocks_0_attentions_0_transformer_blocks_0_attn1_to_out_0` ->
    `down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_out.0.weight`.
    The name is re-split on known structural tokens as JAX's
    `_kohya_module_to_flax` (`models/convert.py:240`) splits it; an unknown
    word is taken as one module name."""
    out, s = [], module
    while s:
        for tok in _KOHYA_TOKENS:
            if s != tok and not s.startswith(tok + "_"):
                continue
            rest = s[len(tok) + 1:]
            m = re.match(r"^(\d+)(?:_(.*))?$", rest) if tok in _KOHYA_INDEXED else None
            if m:
                out.append(f"{tok}.{m.group(1)}")
                s = m.group(2) or ""
            else:
                out.extend(_KOHYA_SPLIT.get(tok, [tok]))
                s = rest
            break
        else:
            head, _, s = s.partition("_")
            out.append(head)
    return ".".join(out) + ".weight"


def convert_lora_from_kohya(
    state_dict: Dict[str, torch.Tensor],
) -> Tuple[Dict[str, Dict[str, torch.Tensor]], Dict[str, float]]:
    """kohya LoRA tensors -> ({weight key: {"down", "up"}}, {weight key:
    alpha}) (JAX `models/convert.py:304`). kohya stores `lora_down.weight`
    (r, in[, kh, kw]) and `lora_up.weight` (out, r[, 1, 1]); `models.lora`
    takes down as it is and up as (out, r). The per-module alpha gives the
    merge its scale alpha / rank."""
    adapters: Dict[str, Dict[str, torch.Tensor]] = {}
    alphas: Dict[str, float] = {}
    for name, value in state_dict.items():
        m = _KOHYA_RE.match(name)
        if not m:
            continue
        key, kind = _kohya_module_to_key(m.group(1)), m.group(2)
        value = torch.as_tensor(value)
        if kind == "alpha":
            alphas[key] = float(value.reshape(-1)[0])
        elif kind == "lora_down":
            adapters.setdefault(key, {})["down"] = value
        else:
            adapters.setdefault(key, {})["up"] = value[:, :, 0, 0] if value.dim() == 4 else value
    return adapters, alphas


def export_lora_to_kohya(
    lora: Dict[str, Dict[str, torch.Tensor]], alpha: float = 8.0,
) -> Dict[str, torch.Tensor]:
    """Inverse of `convert_lora_from_kohya` (JAX `models/convert.py:339`):
    adapters trained here, in the reference's kohya format."""
    out: Dict[str, torch.Tensor] = {}
    for key, ab in lora.items():
        flat = "lora_unet_" + key[: -len(".weight")].replace(".", "_")
        down, up = ab["down"].detach().cpu(), ab["up"].detach().cpu()
        out[f"{flat}.lora_down.weight"] = down
        out[f"{flat}.lora_up.weight"] = up[:, :, None, None] if down.dim() == 4 else up
        out[f"{flat}.alpha"] = torch.tensor(alpha, dtype=torch.float32)
    return out


# ---------------------------------------------------------------------------
# The metric suite
# ---------------------------------------------------------------------------
_METRIC_INDEXED = ("blocks", "layer")
_METRIC_LEAVES = {"kernel": "weight", "scale": "weight", "embedding": "weight", "bias": "bias",
                  "mean": "running_mean", "var": "running_var"}


def metric_state_dict_from_flax(tree) -> Dict[str, torch.Tensor]:
    """A JAX metric module's variables ({"params": ..., ["batch_stats":
    ...]} or the bare params tree, numpy leaves) -> the state dict of the
    port's module of the same name (`metrics.inception`, `metrics.vit`,
    `metrics.lpips`, `metrics.image_reward`). Leaves other than kernels,
    norms, embeddings and BatchNorm statistics (class and position
    embeddings, DINOv2's `ls1`/`ls2`) keep their names."""
    parts = [tree["params"], tree.get("batch_stats", {})] if "params" in tree else [tree]
    out = {}
    for part in parts:
        for path, value in _leaves(part):
            names = []
            for p in path[:-1]:
                head, _, idx = p.rpartition("_")
                names.append(f"{head}.{idx}" if head in _METRIC_INDEXED and idx.isdigit() else p)
            leaf = path[-1]
            if leaf == "kernel":
                value = np.transpose(value, (3, 2, 0, 1)) if value.ndim == 4 else value.T
            out[".".join(names + [_METRIC_LEAVES.get(leaf, leaf)])] = torch.tensor(np.array(value))
    return out


def _t(value) -> torch.Tensor:
    return torch.as_tensor(value).float()


def convert_inception_weights(state_dict: Dict) -> Dict[str, torch.Tensor]:
    """pytorch-fid's `pt_inception-2015-12-05` state dict ->
    `metrics.inception.InceptionV3Features` (JAX :433). The module names are
    the published ones; the classifier (`fc.*`), the auxiliary head and the
    BatchNorm batch counters are dropped."""
    return {k: _t(v) for k, v in state_dict.items()
            if not (k.startswith("fc.") or "AuxLogits" in k or k.endswith("num_batches_tracked"))}


def convert_clip_text_from_transformers(state_dict: Dict) -> Dict[str, torch.Tensor]:
    """transformers `CLIPTextModel(WithProjection)` -> `models.clip.CLIPTextModel`
    (JAX :189), whose names are transformers'; `position_ids` is dropped."""
    return {k: _t(v) for k, v in state_dict.items() if "position_ids" not in k}


def convert_clip_vision_from_transformers(state_dict: Dict) -> Dict[str, torch.Tensor]:
    """transformers `CLIPVisionModel(WithProjection)` -> `metrics.vit.ViTEncoder`
    (JAX :379): vision_model.embeddings.{class_embedding,
    patch_embedding.weight, position_embedding.weight}, pre_layrnorm (sic),
    encoder.layers.N.{self_attn.{q,k,v,out}_proj, layer_norm1/2, mlp.fc1/2},
    post_layernorm, [visual_projection.weight]."""
    fixed = {"embeddings.class_embedding": "class_embedding",
             "embeddings.patch_embedding.weight": "patch_embed.weight",
             "embeddings.patch_embedding.bias": "patch_embed.bias",
             "embeddings.position_embedding.weight": "position_embedding",
             "visual_projection.weight": "projection.weight"}
    out = {}
    for key, value in state_dict.items():
        k = key.replace("vision_model.", "")
        if "position_ids" in k:
            continue
        if k in fixed:
            k = fixed[k]
        elif k.startswith(("pre_layrnorm.", "pre_layernorm.")):
            k = "pre_layernorm." + k.rpartition(".")[2]
        elif k.startswith("encoder.layers."):
            layer, rest = k[len("encoder.layers."):].split(".", 1)
            rest = (rest.replace("self_attn.", "").replace("mlp.", "")
                    .replace("layer_norm1", "norm1").replace("layer_norm2", "norm2"))
            k = f"blocks.{layer}.{rest}"
        elif not k.startswith("post_layernorm."):
            continue
        out[k] = _t(value)
    return out


def _timm_vit(state_dict: Dict, n_pos: Optional[int]) -> Dict[str, torch.Tensor]:
    """A timm-style ViT (torch-hub DINOv2, BLIP's visual encoder) ->
    `metrics.vit.ViTTrunk` names: cls_token (1, 1, D), pos_embed (1, N+1, D)
    (its first `n_pos` rows: the module slices, it does not interpolate),
    patch_embed.proj, blocks.N.{norm1, attn.qkv (fused, split in thirds),
    attn.proj, ls1.gamma, norm2, mlp.fc1/2, ls2.gamma}, norm."""
    out = {}
    for key, value in state_dict.items():
        value = _t(value)
        if key == "cls_token":
            out["class_embedding"] = value.reshape(-1)
        elif key == "pos_embed":
            out["position_embedding"] = value[0, :n_pos]
        elif key.startswith("patch_embed.proj."):
            out["patch_embed." + key.rpartition(".")[2]] = value
        elif key.startswith("norm."):
            out["post_layernorm." + key.rpartition(".")[2]] = value
        elif key.startswith("blocks."):
            _, layer, rest = key.split(".", 2)
            prefix, leaf = f"blocks.{layer}.", rest.rpartition(".")[2]
            if rest.startswith("attn.qkv."):
                for name, chunk in zip(("q_proj", "k_proj", "v_proj"), value.chunk(3, dim=0)):
                    out[f"{prefix}{name}.{leaf}"] = chunk.contiguous()
            elif rest.startswith("attn.proj."):
                out[f"{prefix}out_proj.{leaf}"] = value
            elif rest.startswith(("ls1.", "ls2.")):
                out[prefix + rest[:3]] = value
            elif rest.startswith(("norm1.", "norm2.")):
                out[prefix + rest] = value
            elif rest.startswith("mlp."):
                out[prefix + rest[len("mlp."):]] = value
    return out


def _n_pos(cfg) -> Optional[int]:
    return None if cfg is None else (cfg.image_size // cfg.patch_size) ** 2 + 1


def convert_dinov2_weights(state_dict: Dict, cfg=None) -> Dict[str, torch.Tensor]:
    """torch-hub DINOv2 ViT state dict -> `metrics.vit.ViTEncoder` (JAX :466);
    `cfg` (a `ViTConfig`) sets how many position rows the module holds."""
    return _timm_vit(state_dict, _n_pos(cfg))


_IR_MLP = {"0": "fc1", "2": "fc2", "4": "fc3", "6": "fc4", "7": "fc5"}


def convert_image_reward_weights(state_dict: Dict, vit_cfg=None) -> Dict[str, torch.Tensor]:
    """ImageReward-v1.0's `ImageReward.pt` -> `metrics.image_reward.ImageReward`
    (JAX :520): blip.visual_encoder.* (timm-style ViT-L/16, `_timm_vit`),
    blip.text_encoder.* (BLIP's BertModel: embeddings.{word_embeddings,
    position_embeddings, LayerNorm}, encoder.layer.N.{attention,
    crossattention}.{self.query/key/value, output.dense, output.LayerNorm},
    intermediate.dense, output.{dense, LayerNorm}) and mlp.layers.{0,2,4,6,7}
    (the five reward Linears). BLIP's projection, ITM and decoder heads are
    not used by scoring and are dropped."""
    vis, out = {}, {}
    for key, value in state_dict.items():
        k = key[len("blip."):] if key.startswith("blip.") else key
        if k.startswith("visual_encoder."):
            vis[k[len("visual_encoder."):]] = value
        elif k.startswith("text_encoder.") and "position_ids" not in k:
            k = k[len("text_encoder."):]
            if k == "embeddings.word_embeddings.weight":
                out["text_encoder.word_embeddings.weight"] = _t(value)
            elif k == "embeddings.position_embeddings.weight":
                out["text_encoder.position_embeddings"] = _t(value)
            elif k.startswith("embeddings.LayerNorm."):
                out["text_encoder.embed_norm." + k.rpartition(".")[2]] = _t(value)
            elif k.startswith("encoder.layer."):
                layer, rest = k[len("encoder.layer."):].split(".", 1)
                for old, new in (("self.", ""), ("output.dense.", "output."),
                                 ("output.LayerNorm.", "norm."), ("intermediate.dense.", "intermediate.")):
                    rest = rest.replace(old, new)
                out[f"text_encoder.layer.{layer}.{rest}"] = _t(value)
        elif k.startswith("mlp.layers."):
            idx, leaf = k[len("mlp.layers."):].split(".", 1)
            if idx in _IR_MLP:
                out[f"mlp.{_IR_MLP[idx]}.{leaf}"] = _t(value)
    out.update({"visual_encoder." + k: v for k, v in _timm_vit(vis, _n_pos(vit_cfg)).items()})
    return out


_VGG_FEATURE_INDEX = {0: "conv0_0", 2: "conv0_1", 5: "conv1_0", 7: "conv1_1", 10: "conv2_0",
                      12: "conv2_1", 14: "conv2_2", 17: "conv3_0", 19: "conv3_1", 21: "conv3_2",
                      24: "conv4_0", 26: "conv4_1", 28: "conv4_2"}


def convert_lpips_weights(vgg_state_dict: Dict, lpips_state_dict: Dict) -> Dict[str, torch.Tensor]:
    """torchvision `vgg16().features` ("features.N.*" or bare "N.*") and the
    LPIPS heads (`lin{i}.model.1.weight`) -> `metrics.lpips.LPIPS` (JAX :642)."""
    out = {}
    for key, value in vgg_state_dict.items():
        parts = key.split(".")
        idx = int(parts[1] if parts[0] == "features" else parts[0])
        if idx in _VGG_FEATURE_INDEX:
            out[f"vgg.{_VGG_FEATURE_INDEX[idx]}.{parts[-1]}"] = _t(value)
    for key, value in lpips_state_dict.items():
        m = re.match(r"^lin(\d)\.model\.1\.weight$", key)
        if m:
            out[f"lin{m.group(1)}.weight"] = _t(value)
    return out
