"""The weights bridge of the PyTorch port (`invertible_cd_tpu_torch.models.convert`)
and its LoRA merge.

* Round trip: the port's state dicts, fed to the JAX package's converters,
  reproduce the Flax param trees exactly (bit for bit).
* Key sets: the port's UNet and VAE state-dict keys and shapes equal those
  of the diffusers-named oracle in `tests/_torch_blocks.py` at the tiny
  configs.
* `merge_lora` matches the JAX one (fp32; atol/rtol 1e-6, rounding only).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invertible_cd_tpu.models import UNetConfig as JUNetConfig
from invertible_cd_tpu.models import VAEConfig as JVAEConfig
from invertible_cd_tpu.models.convert import (
    convert_clip_text_from_transformers,
    convert_unet_from_diffusers,
    convert_vae_from_diffusers,
)
from invertible_cd_tpu.models.lora import find_lora_targets as jfind_lora_targets
from invertible_cd_tpu.models.lora import merge_lora as jmerge_lora
from invertible_cd_tpu_torch.models import convert
from invertible_cd_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from invertible_cd_tpu_torch.models.lora import find_lora_targets, merge_lora
from invertible_cd_tpu_torch.models.unet2d import UNet2DCondition, UNetConfig
from invertible_cd_tpu_torch.models.vae import AutoencoderKL, VAEConfig

from _torch_blocks import AutoencoderKL as OracleVAE
from _torch_blocks import UNet2DConditionModel as OracleUNet
from _torch_jax_params import seeded_tiny_bundle


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v)
    return out


def _shapes(sd):
    return {k: tuple(v.shape) for k, v in sd.items()}


@pytest.fixture(scope="module")
def tiny_pipe():
    """The JAX tiny bundle with numpy-seeded weights (this module's, in place
    of the session's Flax-initialised one)."""
    return seeded_tiny_bundle()


@pytest.mark.parametrize(
    "model,to_torch,to_flax",
    [
        ("reverse", convert.unet_state_dict_from_flax, convert_unet_from_diffusers),
        ("vae", convert.vae_state_dict_from_flax, convert_vae_from_diffusers),
        ("text", convert.clip_state_dict_from_flax, convert_clip_text_from_transformers),
    ],
)
def test_bridge_round_trips_exactly(tiny_pipe, model, to_torch, to_flax):
    tree = _np_tree(tiny_pipe.params[model])
    back = to_flax(to_torch(tree))
    want, got = _flat(tree), _flat(back)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_unet_keys_match_diffusers_oracle():
    port = UNet2DCondition(UNetConfig.tiny()).state_dict()
    oracle = OracleUNet(JUNetConfig.tiny()).state_dict()
    assert _shapes(port) == _shapes(oracle)


def test_vae_keys_match_diffusers_oracle():
    port = AutoencoderKL(VAEConfig.tiny()).state_dict()
    oracle = OracleVAE(JVAEConfig.tiny()).state_dict()
    assert _shapes(port) == _shapes(oracle)


def test_bridged_state_dicts_load_strictly(tiny_pipe):
    p = tiny_pipe.params
    UNet2DCondition(UNetConfig.tiny()).load_state_dict(
        convert.unet_state_dict_from_flax(_np_tree(p["reverse"])))
    AutoencoderKL(VAEConfig.tiny()).load_state_dict(
        convert.vae_state_dict_from_flax(_np_tree(p["vae"])))
    CLIPTextModel(CLIPTextConfig.tiny()).load_state_dict(
        convert.clip_state_dict_from_flax(_np_tree(p["text"])))


def test_merge_lora_matches_jax(tiny_pipe):
    rank, alpha = 4, 8.0
    params = tiny_pipe.params["reverse"]["params"]
    rng = np.random.default_rng(5)
    jlora, tlora = {}, {}
    sd = convert.unet_state_dict_from_flax(_np_tree(params))
    for path in jfind_lora_targets(params):
        kernel = np.asarray(_get(params, path))
        if kernel.ndim == 2:
            down = rng.normal(size=(kernel.shape[0], rank)).astype(np.float32)
            t_down = down.T
        else:
            down = rng.normal(size=kernel.shape[:3] + (rank,)).astype(np.float32)
            t_down = down.transpose(3, 2, 0, 1)  # (kh,kw,in,r) -> (r,in,kh,kw)
        up = rng.normal(size=(rank, kernel.shape[-1])).astype(np.float32)
        jlora["/".join(path)] = {"down": jnp.asarray(down), "up": jnp.asarray(up)}
        key = next(iter(convert.unet_state_dict_from_flax(_nest(path, kernel))))
        tlora[key] = {"down": torch.from_numpy(np.ascontiguousarray(t_down)),
                      "up": torch.from_numpy(np.ascontiguousarray(up.T))}
    assert sorted(tlora) == sorted(find_lora_targets(sd))
    want = convert.unet_state_dict_from_flax(
        _np_tree(jmerge_lora(params, jlora, alpha=alpha, rank=rank)))
    got = merge_lora(sd, tlora, alpha=alpha, rank=rank)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), atol=1e-6, rtol=1e-6, err_msg=key)
    changed = [k for k in sd if not torch.equal(got[k], sd[k])]
    assert sorted(changed) == sorted(tlora)


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _nest(path, value):
    tree = value
    for p in reversed(path):
        tree = {p: tree}
    return tree
