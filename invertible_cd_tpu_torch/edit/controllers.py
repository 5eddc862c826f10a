"""Prompt-to-prompt attention controllers: pure functions + explicit state.

PyTorch counterpart of `invertible_cd_tpu/edit/controllers.py` for the
few-step samplers and the 50-step DDIM loop, both run step by step:

  * `ControllerSpec` (JAX :54) holds the static structure: controller
    kind, replace-step ranges, blend setup. The attention routing reads it
    (`ControllerRuntime.hook_factory`'s `applies`).
  * `ControllerArrays` (JAX :72) holds the per-edit data as plain tensors:
    token mappers, per-step cross-replace alphas, equalizers, blend word
    masks. `make_controller` builds them on the CPU; the pipeline moves them
    to its device once per edit (`ControllerArrays.to`), never per hook call.
  * `ControllerRuntime` (JAX :368) wires both into the sampler's
    `hook_factory` / `step_callback` slots; attention maps recorded for
    LocalBlend and the store are ordinary tensors. The 50-step DDIM loop
    keeps the store as a per-layer running sum (`take_step_store`,
    `add_step_store`, `finalize_store`), as JAX's scan form does; the
    scan form's traced twins of `step_callback` (`scan_step_callback`,
    `stacked_step_maps`) have no counterpart, since the eager loop calls
    `step_callback` itself at every step.

Semantics follow the reference controllers (transcribed in
`tests/_torch_p2p_ref.py`): AttentionStore (maps <= 32^2 tokens),
AttentionReplace (einsum with a 77x77 word mapper), AttentionRefine
(gather through the alignment), AttentionReweight (scale token columns),
LocalBlend (spatial mask from 16^2 cross maps), SpatialReplace. The
controller edits only the cond rows: the w-conditioned sampler runs no
uncond rows, and the CFG path wraps the hook (`sampler._wrap_cond_half`).

Probabilities are (B, H, Sq, Sk) fp32 (`models.attention.explicit_attention`);
latents are NCHW.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..models.attention import AttnMeta
from .aligner import MAX_NUM_WORDS, get_refinement_mapper, get_replacement_mapper, get_word_inds

STORE_MAX_TOKENS = 32 * 32  # store (and self-replace) only maps of <= 32^2 tokens
BLEND_RES = 16  # LocalBlend reads the 16x16 cross maps


# ---------------------------------------------------------------------------
# Static spec + per-edit arrays
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ControllerSpec:
    """Hashable controller structure (JAX `controllers.py:54`)."""

    kind: str  # "empty" | "store" | "replace" | "refine" | "spatial_replace"
    reweight: bool = False
    batch_size: int = 2  # number of prompts (cond rows)
    num_steps: int = 4
    self_replace_range: Tuple[int, int] = (0, 0)  # [lo, hi) in steps
    local_blend: bool = False
    has_substruct: bool = False
    start_blend: int = 0
    blend_th: Tuple[float, float] = (0.3, 0.3)
    store_all: bool = False  # keep every <=32^2 map (visualisation store)
    spatial_stop_inject: int = 0


@dataclasses.dataclass
class ControllerArrays:
    """Per-edit data (JAX `controllers.py:72`). Unused fields hold size-0
    placeholders, as in the JAX package."""

    cross_replace_alpha: torch.Tensor  # (num_steps+1, B-1, 1, 1, 77)
    mapper_matrix: torch.Tensor  # (B-1, 77, 77) replace; (0,) otherwise
    mapper_idx: torch.Tensor  # (B-1, 77) int64 refine; (0,) otherwise
    refine_alphas: torch.Tensor  # (B-1, 1, 1, 77) refine; (0,) otherwise
    equalizer: torch.Tensor  # (B-1 or 1, 77) reweight; (0,) otherwise
    alpha_layers: torch.Tensor  # (B, 1, 1, 1, 1, 77) local blend; (0,)
    substruct_layers: torch.Tensor  # same, optional

    def to(self, device) -> "ControllerArrays":
        """The same arrays on `device` (one copy per edit)."""
        return ControllerArrays(**{
            f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)
        })


def _empty() -> torch.Tensor:
    return torch.zeros((0,), dtype=torch.float32)


# ---------------------------------------------------------------------------
# Host-side construction
# ---------------------------------------------------------------------------
def get_equalizer(
    text: str,
    word_select: Union[str, int, Sequence],
    values: Sequence[float],
    tokenizer,
    max_len: int = MAX_NUM_WORDS,
) -> np.ndarray:
    """(1, 77) per-token attention scale (JAX `controllers.py:92`)."""
    if isinstance(word_select, (int, str)):
        word_select = (word_select,)
    eq = np.ones((1, max_len), np.float32)
    for word, val in zip(word_select, values):
        eq[:, get_word_inds(text, word, tokenizer)] = val
    return eq


def get_time_words_attention_alpha(
    prompts: Sequence[str],
    num_steps: int,
    cross_replace_steps: Union[float, Dict],
    tokenizer,
    max_len: int = MAX_NUM_WORDS,
) -> np.ndarray:
    """Per-step, per-target-token mix-in weight for cross-attention editing
    (JAX `controllers.py:109`): 1 inside the replace window, 0 outside;
    per-word overrides via a {word: (start_frac, end_frac)} dict."""
    if not isinstance(cross_replace_steps, dict):
        cross_replace_steps = {"default_": cross_replace_steps}
    if "default_" not in cross_replace_steps:
        cross_replace_steps["default_"] = (0.0, 1.0)

    def window(alpha, bounds, prompt_i, word_inds=None):
        if not isinstance(bounds, (tuple, list)):
            bounds = (0.0, bounds)
        start = int(bounds[0] * alpha.shape[0])
        end = int(bounds[1] * alpha.shape[0])
        if word_inds is None:
            word_inds = np.arange(alpha.shape[2])
        alpha[:start, prompt_i, word_inds] = 0
        alpha[start:end, prompt_i, word_inds] = 1
        alpha[end:, prompt_i, word_inds] = 0
        return alpha

    alpha = np.zeros((num_steps + 1, len(prompts) - 1, max_len), np.float32)
    for i in range(len(prompts) - 1):
        alpha = window(alpha, cross_replace_steps["default_"], i)
    for key, bounds in cross_replace_steps.items():
        if key == "default_":
            continue
        for i in range(1, len(prompts)):
            inds = get_word_inds(prompts[i], key, tokenizer)
            if len(inds) > 0:
                alpha = window(alpha, bounds, i - 1, inds)
    return alpha.reshape(num_steps + 1, len(prompts) - 1, 1, 1, max_len)


def _word_mask(prompts: Sequence[str], words_per_prompt, tokenizer, max_len: int) -> np.ndarray:
    """(B, 1, 1, 1, 1, 77) one-hot token masks for blend words (JAX
    `controllers.py:149`)."""
    m = np.zeros((len(prompts), 1, 1, 1, 1, max_len), np.float32)
    for i, (prompt, words) in enumerate(zip(prompts, words_per_prompt)):
        if isinstance(words, str):
            words = [words]
        for word in words:
            m[i, ..., get_word_inds(prompt, word, tokenizer)] = 1.0
    return m


def make_controller(
    prompts: Sequence[str],
    tokenizer,
    num_steps: int,
    is_replace_controller: bool = True,
    cross_replace_steps: Union[float, Dict] = 0.8,
    self_replace_steps: Union[float, Tuple[float, float]] = 0.4,
    blend_words=None,
    equalizer_params: Optional[Dict] = None,
    substruct_words=None,
    start_blend: float = 0.0,
    blend_th: Tuple[float, float] = (0.3, 0.3),
) -> Tuple[ControllerSpec, ControllerArrays]:
    """Spec + arrays (on the CPU) for an edit (JAX `controllers.py:162`)."""
    b = len(prompts)
    if isinstance(self_replace_steps, float):
        self_replace_steps = (0.0, self_replace_steps)
    spec = ControllerSpec(
        kind="replace" if is_replace_controller else "refine",
        reweight=equalizer_params is not None,
        batch_size=b,
        num_steps=num_steps,
        self_replace_range=(
            int(num_steps * self_replace_steps[0]),
            int(num_steps * self_replace_steps[1]),
        ),
        local_blend=blend_words is not None,
        has_substruct=substruct_words is not None,
        start_blend=int(start_blend * num_steps),
        blend_th=tuple(blend_th),
    )
    empty = _empty()
    mm = mi = ra = eq = al = sl = empty
    if is_replace_controller:
        mm = torch.from_numpy(get_replacement_mapper(prompts, tokenizer))
    else:
        mi_, ra_ = get_refinement_mapper(prompts, tokenizer)
        mi = torch.from_numpy(mi_.astype(np.int64))
        ra = torch.from_numpy(ra_.reshape(b - 1, 1, 1, MAX_NUM_WORDS).astype(np.float32))
    if equalizer_params is not None:
        eq = torch.from_numpy(get_equalizer(
            prompts[1], equalizer_params["words"], equalizer_params["values"], tokenizer))
    if blend_words is not None:
        al = torch.from_numpy(_word_mask(prompts, blend_words, tokenizer, MAX_NUM_WORDS))
    if substruct_words is not None:
        sl = torch.from_numpy(_word_mask(prompts, substruct_words, tokenizer, MAX_NUM_WORDS))
    cra = get_time_words_attention_alpha(prompts, num_steps, cross_replace_steps, tokenizer)
    arrays = ControllerArrays(
        cross_replace_alpha=torch.from_numpy(cra), mapper_matrix=mm, mapper_idx=mi,
        refine_alphas=ra, equalizer=eq, alpha_layers=al, substruct_layers=sl,
    )
    return spec, arrays


# ---------------------------------------------------------------------------
# Attention edit
# ---------------------------------------------------------------------------
def _replace_cross(spec: ControllerSpec, arrays: ControllerArrays, base, repl):
    """base: (H, Sq, 77); repl: (B-1, H, Sq, 77) (JAX `controllers.py:238`)."""
    if spec.kind == "replace":
        out = torch.einsum("hpw,bwn->bhpn", base, arrays.mapper_matrix)
    else:  # refine: gather the base's columns through the alignment
        gathered = base[..., arrays.mapper_idx].movedim(2, 0)  # (B-1, H, Sq, 77)
        out = gathered * arrays.refine_alphas + repl * (1.0 - arrays.refine_alphas)
    if spec.reweight:
        out = out * arrays.equalizer[:, None, None, :]
    return out


def edit_attention(
    spec: ControllerSpec,
    arrays: ControllerArrays,
    probs: torch.Tensor,
    meta: AttnMeta,
    step: int,
) -> torch.Tensor:
    """Apply the controller to one layer's attention probabilities (JAX
    `controllers.py:254`, static step).

    probs: (B, H, Sq, Sk), cond rows only, row 0 the base prompt. Row 0 is
    never edited; self maps of more than 32^2 tokens pass through."""
    if spec.kind in ("empty", "store", "spatial_replace"):
        return probs
    base, repl = probs[0], probs[1:]
    if not meta.is_cross and meta.query_len > STORE_MAX_TOKENS:
        return probs
    if meta.is_cross:
        alpha = arrays.cross_replace_alpha[step]  # (B-1, 1, 1, 77)
        new = _replace_cross(spec, arrays, base, repl)
        new = new * alpha + (1.0 - alpha) * repl
        return torch.cat([probs[:1], new.to(probs.dtype)], dim=0)
    lo, hi = spec.self_replace_range
    if lo <= step < hi:
        return torch.cat([probs[:1], base[None].expand_as(repl)], dim=0)
    return probs


# ---------------------------------------------------------------------------
# LocalBlend
# ---------------------------------------------------------------------------
def _blend_mask(maps, word_mask, th: float, use_pool: bool, out_hw):
    """maps: (B, L, 1, 16, 16, 77); word_mask: (B, 1, 1, 1, 1, 77) -> bool
    (B, 1, H, W), with the base row's mask joined to every row (JAX
    `controllers.py:310`). The 3x3 max window pads with -inf and the resize
    is nearest-neighbour with src = floor(dst * src_size / dst_size), the
    semantics JAX's `_nearest_resize` (:297) rebuilds."""
    m = (maps * word_mask).sum(-1).mean(1)  # (B, 1, 16, 16)
    if use_pool:
        m = F.max_pool2d(m, 3, 1, 1)
    m = F.interpolate(m, size=tuple(out_hw), mode="nearest")
    m = m / m.amax(dim=(2, 3), keepdim=True)
    mask = m > th
    return mask[:1] | mask


def local_blend(
    spec: ControllerSpec,
    arrays: ControllerArrays,
    x_t: torch.Tensor,
    maps16: List[torch.Tensor],
    step: int,
) -> torch.Tensor:
    """Blend edited latents back onto the base outside the edit region
    (JAX `controllers.py:328`). x_t: (B, C, H, W) NCHW latents; maps16:
    accumulated 16x16 cross maps, each (B, heads, 256, 77)."""
    if not maps16 or step + 1 <= spec.start_blend:
        return x_t
    b = x_t.shape[0]
    stacked = torch.cat(
        [m.reshape(b, -1, 1, BLEND_RES, BLEND_RES, MAX_NUM_WORDS) for m in maps16], dim=1
    ).float()
    hw = x_t.shape[2:]
    mask = _blend_mask(stacked, arrays.alpha_layers, spec.blend_th[0], True, hw)
    if spec.has_substruct:
        mask = mask & ~_blend_mask(stacked, arrays.substruct_layers, spec.blend_th[1], False, hw)
    return x_t[:1] + mask.to(x_t.dtype) * (x_t - x_t[:1])


# ---------------------------------------------------------------------------
# Runtime: wires spec + arrays into the sampler
# ---------------------------------------------------------------------------
class ControllerRuntime:
    """Per-run controller glue (JAX `controllers.py:368`). Create one per
    sampling call (it owns the stores); pass `.hook_factory` and
    `.step_callback` into the sampler."""

    def __init__(self, spec: ControllerSpec, arrays: ControllerArrays):
        self.spec = spec
        self.arrays = arrays
        self._step_maps: List[torch.Tensor] = []  # this step's 16^2 cross maps
        self._accum_maps: List[torch.Tensor] = []  # running sum across steps
        self.store: Dict[str, List[torch.Tensor]] = {}  # full store (store_all)

    def _blends(self, meta: AttnMeta) -> bool:
        return (self.spec.local_blend and meta.is_cross
                and meta.query_len == BLEND_RES * BLEND_RES)

    def _stores(self, meta: AttnMeta) -> bool:
        return self.spec.store_all and meta.query_len <= STORE_MAX_TOKENS

    def hook_factory(self, step: int):
        """The attention hook of sampler step `step`, with its static
        `applies(meta)` predicate (JAX :384-412): a layer where the hook is
        the identity keeps the fused kernel, so no (B, H, Sq, Sk)
        probabilities are materialised where nothing reads or edits them."""
        spec = self.spec

        def applies(meta: AttnMeta) -> bool:
            if self._stores(meta) or self._blends(meta):
                return True
            if spec.kind in ("empty", "store", "spatial_replace"):
                return False
            if meta.is_cross:
                return True
            lo, hi = spec.self_replace_range
            return lo <= step < hi and meta.query_len <= STORE_MAX_TOKENS

        def hook(probs: torch.Tensor, meta: AttnMeta) -> torch.Tensor:
            # the stored maps, LocalBlend's included, are the edited ones (the
            # reference stores the tensor that its edit then writes into)
            edited = edit_attention(spec, self.arrays, probs, meta, step)
            if self._stores(meta):
                self.store.setdefault(meta.store_key, []).append(edited)
            if self._blends(meta):
                self._step_maps.append(edited.float())
            return edited

        hook.applies = applies
        return hook

    # -- the step-summed store of the 50-step DDIM loop -----------------------
    def take_step_store(self) -> Dict[str, List[torch.Tensor]]:
        """Clear and return the maps the hooks stored during one step, as
        {store_key: [fp32 map per layer, in call order]} (JAX :448-465):
        the running sum's seed at step 0 and its increment after."""
        out = {k: [m.float() for m in v] for k, v in self.store.items() if v}
        self.store = {}
        return out

    def add_step_store(self, sums: Dict[str, List[torch.Tensor]]) -> Dict[str, List[torch.Tensor]]:
        """`sums` plus this step's maps (every hooked layer fires every step,
        in the same order; JAX :467-472). A step whose store keys or map
        counts differ from the sums' raises instead of being truncated."""
        step = self.take_step_store()
        if sums.keys() != step.keys() or any(len(sums[k]) != len(step[k]) for k in sums):
            raise ValueError(
                "add_step_store: this step stored "
                f"{ {k: len(v) for k, v in step.items()} } maps, the sums hold "
                f"{ {k: len(v) for k, v in sums.items()} }")
        return {k: [a + b for a, b in zip(sums[k], step[k])] for k in sums}

    def finalize_store(self, sums: Dict[str, List[torch.Tensor]], num_steps: int) -> None:
        """Store the step-averaged map of each layer (JAX :474-480); the
        `aggregate_attention` of it equals that of the per-step store."""
        self.store = {k: [v / num_steps for v in vs] for k, vs in sums.items()}

    def step_callback(self, x_t: torch.Tensor, step: int) -> torch.Tensor:
        """After hop `step` (JAX :507): SpatialReplace copies the base row
        while injecting; LocalBlend adds this step's maps to the running sum
        and blends. x_t is NCHW."""
        spec = self.spec
        if spec.kind == "spatial_replace":
            if step < spec.spatial_stop_inject:
                x_t = x_t[:1].expand_as(x_t)
            return x_t
        if spec.local_blend:
            if not self._accum_maps:
                self._accum_maps = list(self._step_maps)
            else:
                self._accum_maps = [a + s for a, s in zip(self._accum_maps, self._step_maps)]
            self._step_maps = []
            x_t = local_blend(spec, self.arrays, x_t, self._accum_maps, step)
        return x_t


def aggregate_attention(
    store: Dict[str, List[torch.Tensor]],
    res: int,
    from_where: Sequence[str],
    is_cross: bool,
    select: int = 0,
) -> torch.Tensor:
    """Average stored attention maps at one resolution into a (res, res, Sk)
    map (JAX `controllers.py:527`). Entries are (B, H, Sq, Sk) per layer per
    step, so the mean over all of them averages across steps too."""
    kind = "cross" if is_cross else "self"
    maps = []
    for place in from_where:
        for probs in store.get(f"{place}_{kind}", []):
            if probs.shape[2] == res * res:
                _, h, _, sk = probs.shape
                maps.append(probs[select].reshape(h, res, res, sk))
    return torch.cat(maps, dim=0).mean(dim=0)


def store_controller(num_steps: int = 50, batch_size: int = 1) -> ControllerSpec:
    """Spec for a pure AttentionStore run (JAX `controllers.py:555`)."""
    return ControllerSpec(kind="store", batch_size=batch_size, num_steps=num_steps, store_all=True)


def spatial_replace_controller(
    num_steps: int, batch_size: int = 2, stop_inject: float = 0.2
) -> Tuple[ControllerSpec, ControllerArrays]:
    """SpatialReplace: copy the base latent onto all rows for the first
    `(1 - stop_inject) * num_steps` steps (JAX `controllers.py:562`)."""
    spec = ControllerSpec(
        kind="spatial_replace", batch_size=batch_size, num_steps=num_steps,
        spatial_stop_inject=int((1.0 - stop_inject) * num_steps),
    )
    return spec, empty_arrays(num_steps, batch_size)


def empty_arrays(num_steps: int, batch_size: int) -> ControllerArrays:
    """Arrays of a controller that edits nothing (JAX `controllers.py:576`)."""
    z = _empty()
    return ControllerArrays(
        cross_replace_alpha=torch.zeros(
            (num_steps + 1, max(batch_size - 1, 1), 1, 1, MAX_NUM_WORDS), dtype=torch.float32),
        mapper_matrix=z, mapper_idx=z, refine_alphas=z, equalizer=z, alpha_layers=z,
        substruct_layers=z,
    )
