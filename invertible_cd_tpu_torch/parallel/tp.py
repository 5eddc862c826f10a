"""Tensor parallelism over the mesh's tp axis: attention heads and FF features split over ranks.

The port's counterpart of JAX's megatron-style tp (`param_sharding`'s
`_TP_COL` / `_TP_ROW`, `invertible_cd_tpu/parallel/mesh.py:102-149`), which
GSPMD partitions; here `tensor_parallel(module, mesh)` gives each tp rank the
slices `param_sharding` names for it, in place, and the reductions are
written out:

  * attention: `to_q`, `to_k` and `to_v` keep this rank's heads (their
    out-features), `heads` becomes H / tp, and `to_out.0` keeps the matching
    in-features (`RowSplitLinear`);
  * feed-forward: GEGLU's `proj` keeps the same feature range of its value
    half and of its gate half, and `net.2` the matching in-features;
  * the input of a split block passes through `mesh.to_tp` (identity
    forward; backward, the input's gradient, of which each rank holds its
    own heads' or features' part, summed over the group), and each
    `RowSplitLinear` sums its partial products over the group by
    `mesh.from_tp` (one all_reduce after `to_out.0`, one after `net.2`;
    identity backward) and adds its bias once, after the sum: the Megatron
    pair, under autograd, so a gradient through a split block is the whole
    block's. Under int8 each row's activation amax is the MAX over the
    group (the whole row's), its weight codes are the whole weight's (its
    in-features sliced, at the whole weight's scales), and the int32
    accumulators are summed before the epilogue, so a call's bits are the
    one-process int8 layer's.

`tp_plan` says which slice of which state-dict key a rank holds (the one
rule; `tensor_parallel` splits by it), and `tp_slice` / `tp_slice_lora`
cut a state dict and an adapter dict by it: the train step runs a split
copy of the UNet on those slices of the whole weights and adapters.

A block whose head count does not divide over tp keeps its attention whole
on every rank (SDXL's 5-head level at tp = 2); JAX splits those columns all
the same and GSPMD reshards them, so the results agree and the layouts
differ. Its feed-forward still splits where its width divides. Every rank of
a tp group runs the same rows; a prompt-to-prompt hook is refused on a split
layer (it would see this rank's heads only). Apply it to a module in its
final dtype and device: the row-split layers keep the whole weight's
per-output amax for int8 (`weight_amax`, a buffer that moves with `.to()`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..models.attention import CrossAttention
from ..models.layers import GEGLU, FeedForward, QLinear
from ..ops import quant
from .mesh import Mesh, all_reduce, from_tp

Plan = Dict[str, Tuple[int, torch.Tensor]]


class RowSplitLinear(QLinear):
    """A linear layer holding the in-features `index` of `layer` (the
    output projection of a tp-split attention or feed-forward block): the
    partial product summed over the tp group, then the whole bias. The
    state-dict keys are `nn.Linear`'s."""

    def __init__(self, layer: nn.Linear, mesh: Mesh, index: torch.Tensor):
        super().__init__(len(index), layer.out_features, bias=layer.bias is not None,
                         device=layer.weight.device, dtype=layer.weight.dtype)
        self.mesh = mesh
        with torch.no_grad():
            self.weight.copy_(layer.weight[:, index])
            if layer.bias is not None:
                self.bias.copy_(layer.bias)
            amax = layer.weight.float().abs().amax(dim=1)
        self.register_buffer("weight_amax", amax, persistent=False)

    def sum_partials(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's partial of a product over the in-features (its own
        or a LoRA adapter's down-projection), summed over the tp group in
        fp32."""
        return from_tp(t.float(), self.mesh)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if quant.current_quant_mode() in quant.INT8_MODES and x.is_floating_point():
            return quant.int8_linear_split(
                x, self.weight, self.bias, quant.weight_codes(self),
                lambda t: all_reduce(t, self.mesh, "tp", dist.ReduceOp.MAX),
                lambda t: all_reduce(t, self.mesh, "tp"))
        y = self.sum_partials(F.linear(x, self.weight))
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(torch.promote_types(x.dtype, self.weight.dtype))


def _rows(layer: nn.Linear, index: torch.Tensor) -> QLinear:
    """A QLinear holding the out-features `index` of `layer` (weight rows
    and bias)."""
    out = QLinear(layer.in_features, len(index), bias=layer.bias is not None,
                  device=layer.weight.device, dtype=layer.weight.dtype)
    with torch.no_grad():
        out.weight.copy_(layer.weight[index])
        if layer.bias is not None:
            out.bias.copy_(layer.bias[index])
    return out


def _attention_index(attn: CrossAttention, mesh: Mesh) -> Optional[torch.Tensor]:
    """The out-features of this rank's heads of `attn` (whole), or None
    when its heads do not divide over tp."""
    tp, i = mesh.tp, mesh.coordinate("tp")
    if attn.heads % tp:
        return None
    n = attn.to_q.out_features // tp
    return torch.arange(i * n, (i + 1) * n)


def _feed_forward_index(ff: FeedForward, mesh: Mesh) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """(GEGLU proj's out-features: this rank's range of the value half and
    the same range of the gate half; net.2's in-features: the range), or
    None when the width does not divide over tp."""
    tp, i = mesh.tp, mesh.coordinate("tp")
    geglu: GEGLU = ff.net[0]
    inner = geglu.proj.out_features // 2
    if inner % tp:
        return None
    n = inner // tp
    cols = torch.arange(i * n, (i + 1) * n)
    return torch.cat([cols, inner + cols]), cols


def tp_plan(module: nn.Module, mesh: Mesh) -> Plan:
    """{state-dict key: (axis, index)}: the slice this tp rank holds of each
    tensor `tensor_parallel` splits (of `module` whole): q/k/v's weights
    (and biases) on axis 0, GEGLU proj's weight and bias on axis 0 (value
    and gate ranges), `to_out.0`'s and `net.2`'s weights on axis 1. Every
    other key stays whole. Empty at tp = 1."""
    plan: Plan = {}
    if mesh.tp == 1:
        return plan
    for name, m in module.named_modules():
        p = f"{name}." if name else ""
        if isinstance(m, CrossAttention):
            index = _attention_index(m, mesh)
            if index is None:
                continue
            for lin in ("to_q", "to_k", "to_v"):
                plan[f"{p}{lin}.weight"] = (0, index)
                if getattr(m, lin).bias is not None:
                    plan[f"{p}{lin}.bias"] = (0, index)
            plan[f"{p}to_out.0.weight"] = (1, index)
        elif isinstance(m, FeedForward):
            index = _feed_forward_index(m, mesh)
            if index is None:
                continue
            rows, cols = index
            plan[f"{p}net.0.proj.weight"] = (0, rows)
            if m.net[0].proj.bias is not None:
                plan[f"{p}net.0.proj.bias"] = (0, rows)
            plan[f"{p}net.2.weight"] = (1, cols)
    return plan


def _cut(t: torch.Tensor, axis: int, index: torch.Tensor) -> torch.Tensor:
    return t.index_select(axis, index.to(t.device))


def tp_slice(state: Dict[str, torch.Tensor], plan: Plan) -> Dict[str, torch.Tensor]:
    """This rank's tensors of a state dict under `plan`: a copy of its slice
    of each split tensor, every other tensor as it is."""
    return {k: _cut(t, *plan[k]) if k in plan else t for k, t in state.items()}


def tp_slice_lora(lora: Dict[str, Dict[str, torch.Tensor]], plan: Plan) -> Dict[str, Dict[str, torch.Tensor]]:
    """This rank's factors of an adapter dict under `plan`, differentiable in
    the whole ones: a layer split on its out-features keeps those rows of
    `up` and the whole `down`, one split on its in-features those columns of
    `down` and the whole `up`. The gradient of a whole factor is then this
    rank's part of it, summed over the tp group to the whole gradient."""
    out = {}
    for key, ab in lora.items():
        if key not in plan:
            out[key] = ab
            continue
        axis, index = plan[key]
        if axis == 0:
            out[key] = {"down": ab["down"], "up": _cut(ab["up"], 0, index)}
        else:
            out[key] = {"down": _cut(ab["down"], 1, index), "up": ab["up"]}
    return out


def split_attention(attn: CrossAttention, mesh: Mesh, index: torch.Tensor) -> None:
    """This rank's heads of `attn` (in place): the out-features `index` of
    q/k/v and the in-features `index` of `to_out.0`."""
    attn.to_q, attn.to_k, attn.to_v = (_rows(lin, index) for lin in (attn.to_q, attn.to_k, attn.to_v))
    attn.to_out[0] = RowSplitLinear(attn.to_out[0], mesh, index)
    attn.heads //= mesh.tp
    attn.tp_mesh = mesh


def split_feed_forward(ff: FeedForward, mesh: Mesh, rows: torch.Tensor, cols: torch.Tensor) -> None:
    """This rank's features of `ff` (in place): GEGLU proj's out-features
    `rows` and net.2's in-features `cols`."""
    geglu: GEGLU = ff.net[0]
    geglu.proj = _rows(geglu.proj, rows)
    ff.net[2] = RowSplitLinear(ff.net[2], mesh, cols)
    ff.tp_mesh = mesh


def tensor_parallel(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Split every attention block and feed-forward of `module` (a UNet)
    over `mesh`'s tp group, in place, at the slices `tp_plan` gives; returns
    `module`. Nothing changes at tp = 1."""
    plan = tp_plan(module, mesh)
    for name, m in list(module.named_modules()):
        p = f"{name}." if name else ""
        if isinstance(m, CrossAttention) and f"{p}to_q.weight" in plan:
            split_attention(m, mesh, plan[f"{p}to_q.weight"][1])
        elif isinstance(m, FeedForward) and f"{p}net.2.weight" in plan:
            split_feed_forward(m, mesh, plan[f"{p}net.0.proj.weight"][1], plan[f"{p}net.2.weight"][1])
    return module
