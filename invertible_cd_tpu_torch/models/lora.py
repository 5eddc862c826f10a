"""LoRA adapters on PyTorch state dicts.

PyTorch counterpart of `init_lora` / `lora_delta` / `merge_lora` in
`invertible_cd_tpu/models/lora.py`. An adapter set is a dict keyed by the
state-dict key of the adapted weight, e.g.
`"down_blocks.0.resnets.0.conv1.weight"`, each entry {"down": A, "up": B}
in torch (kohya) layout:

  * linear weight (out, in):        down (r, in),        up (out, r);
  * conv weight (out, in, kh, kw):  down (r, in, kh, kw), up (out, r).

Merging gives W' = W + (alpha / r) * up∘down; it is differentiable in
`down` and `up`, which is how training reaches the adapters
(`merged_state_dict` + `call_with_state`). `call_with_lora` is the lazy
counterpart of `lora_interceptor` / `apply_with_lora`: it adds each
adapter's low-rank path to its layer's output during the call, so no merged
weight (and, under a gradient, no full-size weight gradient) exists.

`call_by_units` is `call_with_state` with the weights fetched one unit of
the module at a time (each child, and each child of a ModuleList child: a
UNet's down, mid and up blocks and its top-level layers): a unit's tensors
exist while it runs, and autograd keeps a reference to them in their place,
by which the backward pass fetches the unit again. The train step gathers
fsdp-sharded weights this way.
"""
from __future__ import annotations

import contextlib
import functools
import re
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.func import functional_call
from torch.nn.utils.stateless import _reparametrize_module

# Modules that receive adapters, in state-dict naming: attention q/k/v/out,
# transformer proj_in/out, GEGLU + FF output, resnet convs + shortcut,
# up/downsamplers and time_emb_proj.
DEFAULT_TARGET_PATTERNS: Tuple[str, ...] = (
    r"\bto_q$", r"\bto_k$", r"\bto_v$", r"\bto_out\.0$",
    r"\bproj_in$", r"\bproj_out$",
    r"\bff\.net\.0\.proj$", r"\bff\.net\.2$",
    r"\bconv1$", r"\bconv2$", r"\bconv_shortcut$",
    r"\bdownsamplers\.0\.conv$", r"\bupsamplers\.0\.conv$",
    r"\btime_emb_proj$",
)


def find_lora_targets(
    state_dict: Dict[str, torch.Tensor], patterns: Sequence[str] = DEFAULT_TARGET_PATTERNS
) -> list:
    """State-dict keys of the weights whose owning module matches a pattern."""
    regs = [re.compile(p) for p in patterns]
    return [
        key for key in state_dict
        if key.endswith(".weight") and any(r.search(key[: -len(".weight")]) for r in regs)
    ]


def seeded_lora(
    state_dict: Dict[str, torch.Tensor], generator: torch.Generator, rank: int = 64,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Synthetic adapters for every target weight, drawn from `generator`
    on the weights' device with the fan-in rule: down ~ N(0, 1/(in*kh*kw)),
    up ~ N(0, 1/rank). Unlike a training init (up = 0), the merged model
    differs from the base, so a merge is visible in the output."""
    lora = {}
    for key in find_lora_targets(state_dict):
        w = state_dict[key]
        fan_in = w[0].numel()
        down = torch.randn((rank,) + tuple(w.shape[1:]), generator=generator,
                           device=w.device, dtype=torch.float32) / fan_in**0.5
        up = torch.randn((w.shape[0], rank), generator=generator,
                         device=w.device, dtype=torch.float32) / rank**0.5
        lora[key] = {"down": down, "up": up}
    return lora


def init_lora(
    state_dict: Dict[str, torch.Tensor], generator: torch.Generator, rank: int = 64,
    targets: Optional[Sequence[str]] = None, dtype=torch.float32,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Training init for every target weight: down ~ N(0, 1/(in*kh*kw)) drawn
    from `generator` on the weights' device, up = 0, so the adapter starts as
    the identity."""
    if targets is None:
        targets = find_lora_targets(state_dict)
    lora = {}
    for key in targets:
        w = state_dict[key]
        if w.dim() not in (2, 4):
            raise ValueError(f"Unsupported weight shape for LoRA: {tuple(w.shape)}")
        fan_in = w[0].numel()
        down = torch.randn((rank,) + tuple(w.shape[1:]), generator=generator,
                           device=w.device, dtype=torch.float32) / fan_in**0.5
        up = torch.zeros((w.shape[0], rank), device=w.device, dtype=dtype)
        lora[key] = {"down": down.to(dtype), "up": up}
    return lora


def lora_delta(down: torch.Tensor, up: torch.Tensor, scale) -> torch.Tensor:
    """Densified adapter delta with the shape of the base weight."""
    if down.dim() == 2:
        return scale * (up @ down)
    return scale * torch.einsum("or,rihw->oihw", up.reshape(up.shape[0], -1), down)


def merge_lora(
    state_dict: Dict[str, torch.Tensor], lora: Dict[str, Dict[str, torch.Tensor]],
    alpha: float = 8.0, rank: int = 64,
) -> Dict[str, torch.Tensor]:
    """Return a new state dict with the adapters fused in:
    W' = W + (alpha/rank) * up∘down. Weights not in `lora` are passed
    through unchanged (same tensors)."""
    scale = alpha / rank
    out = dict(state_dict)
    for key, ab in lora.items():
        base = state_dict[key]
        delta = lora_delta(ab["down"].to(base.device), ab["up"].to(base.device), scale)
        out[key] = base + delta.to(base.dtype)
    return out


def merged_state_dict(
    state_dict: Dict[str, torch.Tensor], lora: Dict[str, Dict[str, torch.Tensor]],
    alpha: float = 8.0, rank: int = 64, dtypes: Optional[Dict[str, torch.dtype]] = None,
) -> Dict[str, torch.Tensor]:
    """`merge_lora` in the weights' own precision (fp32 base, fp32 adapters),
    then one cast of every tensor to `dtypes[key]` — the dtype the module
    computes that parameter in (`compute_dtypes`). Differentiable in the
    adapters."""
    merged = merge_lora(state_dict, lora, alpha=alpha, rank=rank)
    if dtypes is None:
        return merged
    return {key: t.to(dtypes[key]) for key, t in merged.items()}


def compute_dtypes(module: torch.nn.Module) -> Dict[str, torch.dtype]:
    """State-dict key -> dtype of the module's own tensor: after
    `cast_compute_weights` the compute dtype, and fp32 for the norms."""
    return {key: t.dtype for key, t in module.state_dict().items()}


def call_with_state(module: torch.nn.Module, state: Dict[str, torch.Tensor], *args, **kwargs):
    """`module(*args, **kwargs)` computed with the tensors of `state` in
    place of the module's own parameters (no copy; gradients flow to whatever
    `state` was computed from)."""
    return functional_call(module, state, args, kwargs)


# ---------------------------------------------------------------------------
# Weights fetched unit by unit
# ---------------------------------------------------------------------------
def module_units(module: torch.nn.Module) -> Dict[str, torch.nn.Module]:
    """The units `call_by_units` fetches weights for, by state-dict prefix:
    each child of `module`, and each child of a ModuleList child (a UNet's
    down, mid and up blocks, and its embeddings and input and output layers
    one by one). Every parameter of `module` lies in one unit."""
    if module._parameters:
        raise ValueError("a module with parameters of its own has no units")
    units = {}
    for name, child in module.named_children():
        if isinstance(child, torch.nn.ModuleList):
            units.update((f"{name}.{i}", c) for i, c in child.named_children())
        else:
            units[name] = child
    return units


class UnitCache:
    """The unit a backward pass fetched last, held while its nodes run (one
    unit at a time, across every `call_by_units` that shares the cache);
    `clear()` drops it, as does every unit's forward."""

    def __init__(self):
        self.held = None  # ((fetch, prefix), {key: tensor})

    def get(self, fetch: Callable, prefix: str) -> Dict[str, torch.Tensor]:
        if self.held is None or self.held[0] != (fetch, prefix):
            self.held = None  # the last unit goes before the next is fetched
            with torch.no_grad():
                self.held = ((fetch, prefix), fetch(prefix))
        return self.held[1]

    def clear(self) -> None:
        self.held = None


class _ByReference:
    """A saved tensor that is (a view of) a unit's weight: its key and the
    view's geometry on the weight's storage."""

    __slots__ = ("key", "size", "stride", "offset")

    def __init__(self, key, t):
        self.key, self.size, self.stride, self.offset = key, t.size(), t.stride(), t.storage_offset()


class _Outer:
    __slots__ = ("packed",)

    def __init__(self, packed):
        self.packed = packed


@contextlib.contextmanager
def _weights_by_reference(storages: Dict[int, str], get: Callable[[str], torch.Tensor]):
    """Autograd saves every tensor that lies on one of `storages` (a unit's
    weights, or views of them, by storage address) as its key, and gets it
    back by `get(key)` when the backward pass needs it; every other tensor
    goes to the hooks outside (`torch.utils.checkpoint`'s, under remat), or
    is saved as it is."""
    outer = torch._C._autograd._top_saved_tensors_default_hooks(False)

    def pack(t):
        key = storages.get(t.untyped_storage().data_ptr())
        if key is not None:
            return _ByReference(key, t)
        return t if outer is None else _Outer(outer[0](t))

    def unpack(p):
        if isinstance(p, _ByReference):
            return get(p.key).as_strided(p.size, p.stride, p.offset)
        return outer[1](p.packed) if isinstance(p, _Outer) else p

    with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
        yield


def call_by_units(module: torch.nn.Module, fetch: Callable[[str], Dict[str, torch.Tensor]],
                  cache: UnitCache, *args, **kwargs):
    """`call_with_state(module, state, ...)`, where the state is fetched one
    unit (`module_units`) at a time: `fetch(prefix)` gives a unit's tensors
    (every state-dict key under `prefix`) just before the unit runs, and
    they go when it returns. Autograd saves each of them (and its views) as
    a reference, and the backward pass fetches the unit again, without a
    gradient, into `cache`: so the unit's tensors must come out the same
    bits each time. Under `torch.utils.checkpoint` (non-reentrant) the
    recompute fetches the units again too. `fetch` may be differentiable
    (a merge of adapters into the weights)."""
    units = module_units(module)

    def unit_forward(prefix: str, unit: torch.nn.Module):
        forward = type(unit).forward

        def run(*a, **kw):
            cache.clear()
            tensors = fetch(prefix)
            storages = {t.untyped_storage().data_ptr(): key for key, t in tensors.items()}
            local = {key[len(prefix) + 1:]: t for key, t in tensors.items()}
            with _weights_by_reference(storages, lambda key: cache.get(fetch, prefix)[key]), \
                    _reparametrize_module(unit, local):
                return forward(unit, *a, **kw)
        return run

    try:
        for prefix, unit in units.items():
            unit.forward = unit_forward(prefix, unit)
        return module(*args, **kwargs)
    finally:
        for unit in units.values():
            unit.__dict__.pop("forward", None)


# ---------------------------------------------------------------------------
# Lazy application: adapters ride each layer call; merged weights (and their
# full-size gradients) are never materialised
# ---------------------------------------------------------------------------
def lora_modules(module: torch.nn.Module, keys) -> Dict[str, torch.nn.Module]:
    """State-dict key of each adapted weight -> the `nn.Linear` or
    `nn.Conv2d` that owns it (the Q-layers, and `parallel.tp`'s split
    QLinear and RowSplitLinear, are such). A key with no such module is an
    error: the lazy path never skips an adapter."""
    out = {}
    for key in keys:
        name = key[: -len(".weight")] if key.endswith(".weight") else None
        try:
            mod = module.get_submodule(name) if name else None
        except AttributeError:
            mod = None
        if not isinstance(mod, (torch.nn.Linear, torch.nn.Conv2d)):
            raise ValueError(f"LoRA key {key!r} names no Linear or Conv2d weight of the module")
        if isinstance(mod, torch.nn.Conv2d) and (mod.groups != 1 or mod.padding_mode != "zeros"):
            raise ValueError(f"LoRA key {key!r}: grouped or non-zero-padded convolution")
        out[key] = mod
    return out


def lora_path(mod: torch.nn.Module, x: torch.Tensor, down: torch.Tensor, up: torch.Tensor,
              scale: float) -> torch.Tensor:
    """scale * the adapter's low-rank path on the layer input `x`, in
    `x.dtype` (both factors cast to it, as JAX casts them):
      Linear: (x @ down^T) @ up^T; on a tp row-split layer (`x` and `down`
              this rank's in-features) x @ down^T is summed over the tp
              group first, as the layer sums its own partials;
      Conv2d: `down` as a convolution at the layer's own stride, padding and
              dilation, then the 1x1 contraction by `up` (NCHW).
    Exactly linear in the weight, so the layer's output plus this equals the
    layer with the merged weight W + scale * up∘down."""
    down, up = down.to(x.dtype), up.to(x.dtype)
    if isinstance(mod, torch.nn.Linear):
        h = F.linear(x, down)
        sum_partials = getattr(mod, "sum_partials", None)  # a layer split on its in-features
        if sum_partials is not None:
            h = sum_partials(h).to(x.dtype)
        return scale * F.linear(h, up)
    h = F.conv2d(x, down, None, mod.stride, mod.padding, mod.dilation)
    return scale * F.conv2d(h, up[:, :, None, None])


def _add_lora_path(ab, scale, mod, inputs, output):
    return output + lora_path(mod, inputs[0], ab["down"], ab["up"], scale).to(output.dtype)


@contextlib.contextmanager
def lora_hooks(module: torch.nn.Module, lora: Dict[str, Dict[str, torch.Tensor]], scale: float,
               targets: Optional[Dict[str, torch.nn.Module]] = None):
    """Within the block, each adapted layer of `module` adds its adapter's
    low-rank path (`lora_path`) to its output. `targets` (`lora_modules`
    of the adapters' keys) may be given to skip the lookup."""
    if targets is None:
        targets = lora_modules(module, lora)
    handles = []
    try:
        for key, mod in targets.items():
            handles.append(mod.register_forward_hook(
                functools.partial(_add_lora_path, lora[key], scale)))
        yield
    finally:
        for h in handles:
            h.remove()


def call_with_lora(module: torch.nn.Module, state: Dict[str, torch.Tensor],
                   lora: Dict[str, Dict[str, torch.Tensor]], scale: float, *args,
                   targets: Optional[Dict[str, torch.nn.Module]] = None, **kwargs):
    """`call_with_state(module, state, ...)` with each adapter's low-rank
    path (`lora_path`) added to its layer's output: equal to the call on
    `merge_lora(state, lora)` and differentiable in the adapters. The hooks
    that add the paths are installed for this call only, so a function
    that calls this is whole under `torch.utils.checkpoint`: its recompute
    during backward installs them again. `targets` (`lora_modules` of the
    adapters' keys) may be given to skip the lookup."""
    with lora_hooks(module, lora, scale, targets):
        return functional_call(module, state, args, kwargs)
