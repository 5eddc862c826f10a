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
  * each `RowSplitLinear` sums its partial products over the tp group (one
    all_reduce after `to_out.0`, one after `net.2`) and adds its bias once,
    after the sum. Under int8 each row's activation amax is the MAX over the
    group (the whole row's), its weight codes are the whole weight's (its
    in-features sliced, at the whole weight's scales), and the int32
    accumulators are summed before the epilogue, so a call's bits are the
    one-process int8 layer's.

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

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..models.attention import CrossAttention
from ..models.layers import GEGLU, FeedForward, QLinear
from ..ops import quant
from .mesh import Mesh, all_reduce


class RowSplitLinear(QLinear):
    """A linear layer holding this rank's slice of its in-features (the
    output projection of a tp-split attention or feed-forward block): the
    partial product summed over the tp group, then the whole bias. The
    state-dict keys are `nn.Linear`'s."""

    def __init__(self, layer: nn.Linear, mesh: Mesh):
        tp, i = mesh.tp, mesh.coordinate("tp")
        n = layer.in_features // tp
        super().__init__(n, layer.out_features, bias=layer.bias is not None,
                         device=layer.weight.device, dtype=layer.weight.dtype)
        self.mesh = mesh
        with torch.no_grad():
            self.weight.copy_(layer.weight[:, i * n:(i + 1) * n])
            if layer.bias is not None:
                self.bias.copy_(layer.bias)
            amax = layer.weight.float().abs().amax(dim=1)
        self.register_buffer("weight_amax", amax, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if quant.current_quant_mode() in quant.INT8_MODES and x.is_floating_point():
            return quant.int8_linear_split(
                x, self.weight, self.bias, quant.weight_codes(self),
                lambda t: all_reduce(t, self.mesh, "tp", dist.ReduceOp.MAX),
                lambda t: all_reduce(t, self.mesh, "tp"))
        y = all_reduce(F.linear(x, self.weight).float(), self.mesh, "tp")
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(torch.promote_types(x.dtype, self.weight.dtype))


def _rows(layer: nn.Linear, index) -> QLinear:
    """A QLinear holding the out-features `index` of `layer` (weight rows
    and bias)."""
    out = QLinear(layer.in_features, len(index), bias=layer.bias is not None,
                  device=layer.weight.device, dtype=layer.weight.dtype)
    with torch.no_grad():
        out.weight.copy_(layer.weight[index])
        if layer.bias is not None:
            out.bias.copy_(layer.bias[index])
    return out


def split_attention(attn: CrossAttention, mesh: Mesh) -> bool:
    """This rank's heads of `attn` (in place); False, and `attn` whole, when
    its heads do not divide over tp."""
    tp, i = mesh.tp, mesh.coordinate("tp")
    if attn.heads % tp:
        return False
    inner = attn.to_q.out_features
    index = torch.arange(i * inner // tp, (i + 1) * inner // tp)
    attn.to_q, attn.to_k, attn.to_v = (_rows(lin, index) for lin in (attn.to_q, attn.to_k, attn.to_v))
    attn.to_out[0] = RowSplitLinear(attn.to_out[0], mesh)
    attn.heads //= tp
    attn.tp_mesh = mesh
    return True


def split_feed_forward(ff: FeedForward, mesh: Mesh) -> bool:
    """This rank's features of `ff` (in place): the same range of GEGLU's
    value and gate halves, and of `net.2`'s in-features; False, and `ff`
    whole, when its width does not divide over tp."""
    tp, i = mesh.tp, mesh.coordinate("tp")
    geglu: GEGLU = ff.net[0]
    inner = geglu.proj.out_features // 2
    if inner % tp:
        return False
    n = inner // tp
    index = torch.cat([torch.arange(i * n, (i + 1) * n), inner + torch.arange(i * n, (i + 1) * n)])
    geglu.proj = _rows(geglu.proj, index)
    ff.net[2] = RowSplitLinear(ff.net[2], mesh)
    return True


def tensor_parallel(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Split every attention block and feed-forward of `module` (a UNet)
    over `mesh`'s tp group, in place; returns `module`. Nothing changes at
    tp = 1."""
    if mesh.tp == 1:
        return module
    for m in list(module.modules()):
        if isinstance(m, CrossAttention):
            split_attention(m, mesh)
        elif isinstance(m, FeedForward):
            split_feed_forward(m, mesh)
    return module
