"""Process layout and collectives on `torch.distributed`.

PyTorch counterpart of `invertible_cd_tpu/parallel/mesh.py`. JAX lays a
`Mesh` over its devices and lets XLA insert the collectives; here there is
one process per card (launched by `torchrun` /
`python -m torch.distributed.run`), and the collectives are written out:

  * `initialize_distributed` joins the process group torchrun describes
    (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`); a
    no-op for one process outside torchrun, as JAX's is. The backend
    follows the device: NCCL for CUDA, gloo for the CPU, unless `backend=`
    is given.
  * `make_mesh` gives the (dp, fsdp, sp, tp) layout of the ranks, built on
    `init_device_mesh` with those axis names; `group("sp")` / `group("tp")`
    are this rank's groups of the two intra-model axes, which
    `parallel.spatial` (each latent's height over sp) and `parallel.tp`
    (attention heads and FF features over tp) partition by hand.
  * `param_sharding` / `shard_params`: JAX's rule for which axis of a
    frozen weight its fsdp shards split, on the port's state-dict keys and
    torch layouts (Linear (out, in), Conv2d (out, in, kh, kw)), so that a
    weight carried over by `models.convert` splits along the same tensor
    axis as JAX's. `ShardedWeights` holds each rank's 1/fsdp of the
    tensors that this rule splits (laid end to end, unit by unit) and
    gathers them again.
  * `shard_batch` / `process_local_batch_slice`: this rank's rows of a
    global batch, contiguous per rank, over dp x fsdp where they divide it
    and over dp alone otherwise (JAX's `shard_batch` asks only that dp
    divide it; `check_batch` raises its error); `latent_rows` / `gather_rows`: this
    rank's rows of a latent's height over sp (JAX's `latent_sharding`) and
    the gather of them back in rank order.
  * `all_reduce_mean`, `all_gather_objects`, `broadcast_object`, `barrier`
    and `is_main`: the reductions, gathers and rank-0-only work of the
    trainer, the eval, serving and the CLIs; `all_reduce_mean` averages
    over the rows' group (`group("rows")`: dp x fsdp), whose ranks hold
    different rows, and never over sp or tp, whose ranks hold the same.
  * `to_tp` / `from_tp`: tp's pair of reductions under autograd (the
    Megatron pair). `to_tp` is the identity forward and sums the gradient
    over the tp group backward (on the input of a layer split on its
    out-features); `from_tp` sums over the tp group forward and is the
    identity backward (after a layer split on its in-features). Neither
    writes into a tensor autograd tracks.

Rows of a batch split over every rank of dp x fsdp (fsdp is data parallel
too); JAX splits them over dp only and lets XLA shard the parameters under
fsdp. The ranks of one sp or tp group hold the same rows. gloo moves CUDA tensors through broadcast and all_reduce only, so
every gather here goes through the host when the backend is gloo.
`Mesh(dp=..., fsdp=...)` with no process group is a layout only (the
counterpart of an abstract mesh), for `param_sharding` and the batch
checks; its collectives refuse to run.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import threading
import weakref
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXES = ("dp", "fsdp", "sp", "tp")


def local_device(device="cuda") -> torch.device:
    """The device this rank runs on: `cuda:{LOCAL_RANK}` for a bare "cuda"
    under torchrun, any other device (or without torchrun) as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return device


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device="cuda",
) -> None:
    """Join the process group (JAX :32). The arguments default to
    torchrun's environment (`WORLD_SIZE`, `RANK`, `MASTER_ADDR:MASTER_PORT`).
    One process outside torchrun does nothing, as JAX's does; under
    torchrun a world of one joins too, so that its collectives run. On
    CUDA the rank's current device becomes `local_device(device)`. Calling
    it again in a process that has joined does nothing."""
    if dist.is_initialized():
        return
    launched = num_processes is None and "RANK" in os.environ and "MASTER_ADDR" in os.environ
    n = int(os.environ.get("WORLD_SIZE", "1")) if num_processes is None else num_processes
    if n <= 1 and not launched:
        return
    rank = int(os.environ["RANK"]) if process_id is None else process_id
    if coordinator_address is None:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    device = local_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            rank=rank, world_size=n)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The (dp, fsdp, sp, tp) layout of the ranks, row-major: rank =
    ((dp_i * fsdp + fsdp_i) * sp + sp_i) * tp + tp_i. `device_mesh` (the
    `DeviceMesh` over the process group) is None for a layout without a
    process group: one process, or a mesh made by hand for the layout
    functions, whose collectives then refuse to run (world size > 1) or
    do nothing (world size 1)."""

    dp: int = 1
    fsdp: int = 1
    sp: int = 1
    tp: int = 1
    rank: int = 0
    device_mesh: object = dataclasses.field(default=None, compare=False, repr=False)
    rows_group: object = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "fsdp": self.fsdp, "sp": self.sp, "tp": self.tp}

    @property
    def size(self) -> int:
        return self.dp * self.fsdp * self.sp * self.tp

    def coordinate(self, axis: str) -> int:
        """This rank's index along `axis`."""
        inner = 1  # ranks per step along `axis`
        for name in reversed(AXES):
            if name == axis:
                return (self.rank // inner) % self.shape[name]
            inner *= self.shape[name]
        raise KeyError(axis)

    @property
    def rows(self) -> int:
        """How many ranks a batch's rows split over where they divide it:
        dp x fsdp (the "rows" group)."""
        return self.dp * self.fsdp

    @property
    def row(self) -> int:
        """This rank's place among them (its block of rows)."""
        return self.coordinate("dp") * self.fsdp + self.coordinate("fsdp")

    def batch_rows(self, batch: int) -> Tuple[int, int]:
        """(ranks, index): how many ranks a global batch of `batch` rows
        splits over, and this rank's place among them. dp x fsdp (`rows`,
        `row`) where it divides the batch; else dp alone, as JAX's
        `shard_batch` splits it, the fsdp ranks of a dp group then taking
        the same rows (their gradients are equal, so the mean over the rows
        group is the mean over dp)."""
        if batch % self.rows == 0:
            return self.rows, self.row
        return self.dp, self.coordinate("dp")

    def group(self, axis: Optional[str] = None):
        """This rank's process group of `axis` ("dp", "fsdp", "sp" or "tp"),
        of "rows" (the dp x fsdp ranks that hold this rank's sp and tp
        coordinates: the ranks a batch's rows split over), or with None
        every rank."""
        if self.device_mesh is None:
            if self.size > 1:
                raise RuntimeError("this mesh has no process group (a layout only)")
            return None
        if axis is None:
            return dist.group.WORLD
        if axis == "rows":
            return self.rows_group
        return self.device_mesh.get_group(axis)


def make_mesh(dp: Optional[int] = None, fsdp: int = 1, sp: int = 1, tp: int = 1,
              device=None) -> Mesh:
    """The (dp, fsdp, sp, tp) mesh over every rank of the process group
    (JAX :48); one rank without a group. dp defaults to
    world // (fsdp * sp * tp). `device` ("cuda" or "cpu") is the
    `DeviceMesh`'s device type; by default the backend's (NCCL: cuda)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if dp is None:  # JAX's assertions, raised so that they hold under -O too
        if n % (fsdp * sp * tp):
            raise AssertionError((n, fsdp, sp, tp))
        dp = n // (fsdp * sp * tp)
    if dp * fsdp * sp * tp != n:
        raise AssertionError(f"mesh {dp}x{fsdp}x{sp}x{tp} != {n} devices")
    if not dist.is_initialized():
        return Mesh(dp, fsdp, sp, tp)
    from torch.distributed.device_mesh import init_device_mesh

    kind = torch.device(device).type if device is not None else (
        "cuda" if dist.get_backend() == "nccl" else "cpu")
    device_mesh = init_device_mesh(kind, (dp, fsdp, sp, tp), mesh_dim_names=AXES)
    rank, inner = dist.get_rank(), sp * tp
    rows_group = dist.group.WORLD
    if inner > 1:  # every rank makes every group, in the same order
        for i in range(inner):
            group = dist.new_group(list(range(i, n, inner)))
            if rank % inner == i:
                rows_group = group
    return Mesh(dp, fsdp, sp, tp, rank=rank, device_mesh=device_mesh, rows_group=rows_group)


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------
def check_batch(b: int, mesh: Mesh) -> None:
    """JAX's `shard_batch` ValueError unless `b` rows split over the mesh's
    dp axis (word for word)."""
    dp = mesh.dp
    if dp > 1 and b % dp != 0:
        raise ValueError(
            f"batch size {b} is not divisible by the mesh's dp={dp} "
            f"axis ({mesh.size} devices as "
            f"dp{mesh.dp}xfsdp{mesh.fsdp}"
            f"xtp{mesh.tp}). Use a batch size that is "
            f"a multiple of {dp}, or shrink dp via --fsdp/--tp (e.g. "
            f"make_mesh(dp={max(d for d in range(1, dp + 1) if b % d == 0)}, ...))."
        )


def process_local_batch_slice(global_batch: int, mesh: Mesh) -> Tuple[int, int]:
    """(start, size) of this rank's contiguous rows of a global batch (JAX
    :182, per host there), split as `Mesh.batch_rows` says."""
    ranks, index = mesh.batch_rows(global_batch)
    per = global_batch // ranks
    return index * per, per


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of a global batch (a tensor, or a dict of them,
    nested; JAX :158); raises JAX's ValueError for a batch that does not
    split over the rows."""
    leaves = _leaves(batch)
    if leaves:
        check_batch(leaves[0].shape[0], mesh)
        start, size = process_local_batch_slice(leaves[0].shape[0], mesh)
    return _map(batch, lambda x: x[start:start + size])


def latent_rows(x: torch.Tensor, mesh: Mesh, dim: int = 2) -> torch.Tensor:
    """This rank's contiguous rows of the height axis `dim` (an NCHW
    latent's 2) over the mesh's sp ranks, a view (JAX :84's
    `latent_sharding` on the height axis); `x` whole when sp = 1."""
    if mesh.sp == 1:
        return x
    h = x.shape[dim]
    if h % mesh.sp:
        raise ValueError(f"height {h} does not split over sp={mesh.sp} ranks")
    n = h // mesh.sp
    return x.narrow(dim, mesh.coordinate("sp") * n, n)


def gather_rows(x: torch.Tensor, mesh: Mesh, dim: int = 2) -> torch.Tensor:
    """The sp group's rows of axis `dim`, concatenated in rank order: the
    whole height on every rank of the group (`latent_rows` undone)."""
    if mesh.sp == 1:
        return x
    return all_gather_cat(x, dim, mesh, "sp")


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
# Transformer weights split over "tp" (JAX :102): q/k/v and GEGLU's
# up-projection on out-features, the output projections on in-features.
_TP_COL = ("to_q", "to_k", "to_v", "proj")
_TP_ROW = ("to_out_0", "net_2")


def _module_name(key: str) -> str:
    """The JAX module name owning a state-dict weight: `...to_out.0.weight`
    -> "to_out_0", `...to_q.weight` -> "to_q"."""
    parts = key.split(".")[:-1]
    if len(parts) > 1 and parts[-1].isdigit():
        return f"{parts[-2]}_{parts[-1]}"
    return parts[-1] if parts else ""


def _jax_axes(key: str, t: torch.Tensor) -> Tuple[int, ...]:
    """The port's axes in the order of the JAX layout of the same weight
    (`models.convert`): conv OIHW <- HWIO, dense (out, in) <- (in, out)."""
    if key.endswith(".weight") and not _module_name(key).endswith("embedding"):
        if t.dim() == 4:
            return (2, 3, 1, 0)
        if t.dim() == 2:
            return (1, 0)
    return tuple(range(t.dim()))


def param_sharding(params: Dict[str, torch.Tensor], mesh: Mesh,
                   min_size: int = 2**16) -> Dict[str, Tuple[Optional[str], ...]]:
    """{key: spec}, spec[i] the mesh axis that axis i of the tensor splits
    over, or None (JAX :119's PartitionSpec in the port's layout): attention
    and FF weights over "tp" (tp > 1), every other leaf of at least
    `min_size` elements over "fsdp" along its largest axis that fsdp
    divides (the first such in JAX's layout on a tie); the rest whole."""
    out = {}
    for key, t in params.items():
        spec: List[Optional[str]] = [None] * t.dim()
        if mesh.tp > 1 and t.dim() == 2 and key.endswith(".weight"):
            owner = _module_name(key)
            if owner in _TP_COL and t.shape[0] % mesh.tp == 0:
                spec[0] = "tp"
            elif owner in _TP_ROW and t.shape[1] % mesh.tp == 0:
                spec[1] = "tp"
            if any(spec):
                out[key] = tuple(spec)
                continue
        if mesh.fsdp > 1 and t.numel() >= min_size:
            axes = _jax_axes(key, t)
            for j in sorted(range(len(axes)), key=lambda j: -t.shape[axes[j]]):
                if t.shape[axes[j]] % mesh.fsdp == 0:
                    spec[axes[j]] = "fsdp"
                    break
        out[key] = tuple(spec)
    return out


def _split_axis(spec: Sequence[Optional[str]]) -> Optional[int]:
    return next((i for i, a in enumerate(spec) if a == "fsdp"), None)


def shard_params(params: Dict[str, torch.Tensor], mesh: Mesh,
                 min_size: int = 2**16) -> Dict[str, torch.Tensor]:
    """This rank's piece of every tensor under `param_sharding` (JAX :152):
    a copy of its fsdp block, or the tensor itself where it stays whole."""
    specs = param_sharding(params, mesh, min_size)
    i = mesh.coordinate("fsdp")
    out = {}
    for key, t in params.items():
        axis = _split_axis(specs[key])
        out[key] = t if axis is None else t.chunk(mesh.fsdp, axis)[i].clone(
            memory_format=torch.contiguous_format)  # a copy: the whole is not kept
    return out


# `ShardedWeights` fills a gathered run from collectives of up to this many
# bytes of each rank's piece (a bounded buffer beside the run's)
GATHER_BYTES = 2**26


class ShardedWeights:
    """Dicts of frozen tensors held in 1/fsdp pieces between uses, and
    gathered over the fsdp group by `gather()`: whole, or the tensors of
    some keys only (the train step gathers one UNet block at a time). The
    tensors that `param_sharding` splits over fsdp are laid end to end, one
    run per unit of `units` (lists of keys; by default one unit of every
    key), dtype and set of dicts holding them, and this rank keeps its
    1/fsdp of each run; the other tensors are held whole. A gather makes a
    run whole in a fresh buffer that the run's tensors view, filled from
    all_gathers of up to GATHER_BYTES of each rank's piece: no collective
    writes the buffer itself (the communication library may hold what it
    wrote for a moment after it returns), so the buffer lives exactly as
    long as its views, and a unit's gather holds its own bytes and one such
    collective's. A tensor that appears in several dicts (or under several
    keys) is held and gathered once.

    `live_bytes` counts the bytes of gathered buffers still alive (until
    the last view of each is gone) and `peak_bytes` the most of them alive
    at once since `reset_peak()`; a rank's peak of these weights is
    `resident_bytes() + peak_bytes`. `live_units` counts the units with a
    gathered buffer alive, and `peak_units` the most at once."""

    def __init__(self, dicts: Sequence[Dict[str, torch.Tensor]], mesh: Mesh,
                 min_size: int = 2**16, units: Optional[Iterable[Iterable[str]]] = None):
        self.mesh = mesh
        def ident(t):  # a detached view of a tensor is the same tensor
            return (t.data_ptr(), t.dtype, tuple(t.shape), t.stride())

        name_of: Dict[tuple, str] = {}  # ident -> the tensor's name in `unique`
        unique: Dict[str, torch.Tensor] = {}
        self.layout: List[Dict[str, str]] = []
        for d in dicts:
            for key, t in d.items():
                if ident(t) not in name_of:
                    name_of[ident(t)] = f"{len(unique)}:{key}"  # the key keeps the layout rule
                    unique[name_of[ident(t)]] = t
            self.layout.append({key: name_of[ident(t)] for key, t in d.items()})
        unit_of = {key: i for i, keys in enumerate(units or ()) for key in keys}
        specs = param_sharding(unique, mesh, min_size)
        held = [set(lay.values()) for lay in self.layout]
        runs: Dict[tuple, List[str]] = {}  # in the dicts' order, the same on every rank
        for n, t in unique.items():
            if _split_axis(specs[n]) is not None:
                holders = tuple(i for i, names in enumerate(held) if n in names)
                runs.setdefault((unit_of.get(n.split(":", 1)[1], -1), t.dtype, holders), []).append(n)
        self.runs = list(runs.values())
        self.run_unit = [unit for unit, _, _ in runs]
        self.run_of = {n: r for r, names in enumerate(self.runs) for n in names}
        self.shapes = {n: unique[n].shape for n in self.run_of}
        self.pieces = {n: t for n, t in unique.items() if n not in self.run_of}
        self.run_pieces = [self._piece([unique[n] for n in names]) for names in self.runs]
        self.run_bytes = [sum(unique[n].numel() for n in names) * unique[names[0]].element_size()
                          for names in self.runs]
        self.whole_bytes = {n: t.numel() * t.element_size() for n, t in unique.items()}
        self._lock = threading.Lock()
        self.live_bytes = self.peak_bytes = self.peak_units = 0
        self._live_runs = collections.Counter()  # unit -> its gathered buffers alive

    def _piece(self, tensors: List[torch.Tensor]) -> torch.Tensor:
        """This rank's 1/fsdp of `tensors` laid end to end (each split
        tensor has an axis that fsdp divides, so the run's length does)."""
        total = sum(t.numel() for t in tensors)
        size = total // self.mesh.fsdp
        lo = self.mesh.coordinate("fsdp") * size
        piece = torch.empty(size, dtype=tensors[0].dtype, device=tensors[0].device)
        start = 0
        for t in tensors:
            a, b = max(lo, start), min(lo + size, start + t.numel())
            if a < b:
                piece[a - lo:b - lo] = t.reshape(-1)[a - start:b - start]
            start += t.numel()
        return piece

    def resident_bytes(self) -> int:
        """Bytes this rank holds between gathers."""
        return sum(t.numel() * t.element_size() for t in [*self.pieces.values(), *self.run_pieces])

    def _names(self, keys: Optional[Iterable[str]], dicts: Sequence[int]) -> set:
        return {n for i in dicts for k, n in self.layout[i].items() if keys is None or k in keys}

    def _runs(self, keys: Optional[Iterable[str]], dicts: Optional[Sequence[int]]) -> List[int]:
        dicts = range(len(self.layout)) if dicts is None else dicts
        names = self._names(None if keys is None else set(keys), dicts)
        return sorted({self.run_of[n] for n in names if n in self.run_of})

    def gathered_bytes(self, keys: Optional[Iterable[str]] = None,
                       dicts: Optional[Sequence[int]] = None) -> int:
        """Bytes a `gather(keys, dicts)` makes whole (its runs')."""
        return sum(self.run_bytes[r] for r in self._runs(keys, dicts))

    @property
    def live_units(self) -> int:
        return len(+self._live_runs)

    def reset_peak(self) -> None:
        with self._lock:
            self.peak_bytes, self.peak_units = self.live_bytes, self.live_units

    def _freed(self, n: int, unit: int) -> None:
        with self._lock:
            self.live_bytes -= n
            self._live_runs[unit] -= 1

    def _gather_run(self, r: int) -> Dict[str, torch.Tensor]:
        """Run `r`'s tensors whole: views of one fresh buffer, counted in
        `live_bytes` until its storage is freed."""
        piece = self.run_pieces[r]
        size, n = piece.numel(), self.mesh.fsdp
        flat = torch.empty(n * size, dtype=piece.dtype, device=piece.device)
        nbytes, unit = flat.untyped_storage().nbytes(), self.run_unit[r]
        with self._lock:
            self.live_bytes += nbytes
            self._live_runs[unit] += 1
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            self.peak_units = max(self.peak_units, self.live_units)
        # the storage's finalizer: it outlives the buffer while a view holds it
        weakref.finalize(flat.untyped_storage(), self._freed, nbytes, unit)
        step = max(1, GATHER_BYTES // piece.element_size())
        for lo in range(0, size, step):
            hi = min(size, lo + step)
            flat.view(n, size)[:, lo:hi] = all_gather_cat(piece[lo:hi], 0, self.mesh).view(n, -1)
        out, offset = {}, 0
        for n in self.runs[r]:
            k = self.shapes[n].numel()
            out[n] = flat[offset:offset + k].view(self.shapes[n])
            offset += k
        return out

    def gather(self, keys: Optional[Iterable[str]] = None,
               dicts: Optional[Sequence[int]] = None) -> List[Dict[str, torch.Tensor]]:
        """The dicts (those at the indices `dicts`, default all), whole, or
        only their tensors of `keys`: views of gathered runs for the split
        ones (every run holding one of them is gathered), the held tensors
        for the others."""
        keys = None if keys is None else set(keys)
        dicts = range(len(self.layout)) if dicts is None else dicts
        full = dict(self.pieces)
        for r in self._runs(keys, dicts):  # the same order on every rank
            full.update(self._gather_run(r))
        return [{k: full[n] for k, n in self.layout[i].items() if keys is None or k in keys}
                for i in dicts]


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def _through_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    """`t`'s copy in host memory, page-locked for a CUDA tensor (the caching
    host allocator reuses it), for the host hop of a gloo collective."""
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda).copy_(t)


def all_gather_cat(t: torch.Tensor, axis: int, mesh: Mesh, mesh_axis: str = "fsdp") -> torch.Tensor:
    """Every rank's `t` of the `mesh_axis` group, concatenated along `axis`
    in rank order."""
    group = mesh.group(mesh_axis)
    if group is None:
        return t
    n = dist.get_world_size(group)
    src = t.contiguous()
    host = _through_host(src, group)
    if host:
        src = _pinned_copy(src)
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device, pin_memory=src.is_pinned())
    # torch >= 2.13 names it all_gather_single (the old name warns)
    getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(out, src, group=group)
    if host:
        out = out.to(t.device)
    # the pieces lie along axis 0 already; another axis is one copy, on t's device
    return out if axis == 0 else torch.cat(out.chunk(n), dim=axis)


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """`t` reduced by `op` over this rank's `axis` group (in place, `t`
    returned; through the host for a CUDA tensor on gloo). Refuses a tensor
    that autograd tracks: an in-place collective is invisible to autograd,
    or (through the host) cuts its gradient; `to_tp` / `from_tp` are the
    reductions under autograd."""
    group = mesh.group(axis)
    if group is None:
        return t
    if t.requires_grad:
        raise RuntimeError("all_reduce writes in place: it takes no tensor that autograd tracks")
    if _through_host(t, group):
        host = _pinned_copy(t)
        dist.all_reduce(host, op=op, group=group)
        return t.copy_(host)
    dist.all_reduce(t, op=op, group=group)
    return t


def all_reduce_sum(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh], axis: str) -> List[torch.Tensor]:
    """The sum of each tensor over this rank's `axis` group, in one
    all_reduce. Fresh tensors; every rank of the group gets the same bits."""
    tensors = list(tensors)
    if mesh is None or not tensors or mesh.group(axis) is None:
        return tensors
    flat = all_reduce(torch.cat([t.detach().reshape(-1) for t in tensors]), mesh, axis)
    return [piece.view_as(t) for piece, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def all_reduce_mean(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh]) -> List[torch.Tensor]:
    """The mean of each tensor over the ranks the rows split over (the
    "rows" group, dp x fsdp: the ranks of an sp or tp group hold the same
    rows and take no part), in one all_reduce (a sum, then a division by
    their number). Fresh tensors; every rank gets the same bits."""
    tensors = list(tensors)
    if mesh is None or not tensors or mesh.group("rows") is None:
        return tensors
    return [t / mesh.rows for t in all_reduce_sum(tensors, mesh, "rows")]


class _ToTP(torch.autograd.Function):
    """Identity forward; the gradient summed over the tp group backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(), ctx.mesh, "tp"), None


class _FromTP(torch.autograd.Function):
    """The sum over the tp group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x.clone(), mesh, "tp")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def to_tp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """`x` as it is, whose gradient is summed over the tp group: the input
    of the layers split on their out-features (each rank's part of the
    gradient comes from its own features)."""
    return _ToTP.apply(x, mesh)


def from_tp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of each rank's `x` over the tp group (a fresh tensor),
    whose gradient reaches each rank's `x` whole: the partial products of
    the layers split on their in-features."""
    return _FromTP.apply(x, mesh)


def all_gather_objects(obj, mesh: Optional[Mesh], axis: Optional[str] = None) -> list:
    """Every rank's picklable `obj` (keep tensors on the host), in rank
    order, on every rank; [obj] without a process group."""
    group = None if mesh is None else mesh.group(axis)
    if group is None:
        return [obj]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def all_gather_in_order(mine: Dict[int, object], mesh: Optional[Mesh]) -> list:
    """Every rank's {index: result} merged, as a list in index order, on
    every rank (the results of a `stride`, put back in order)."""
    merged = {}
    for part in all_gather_objects(mine, mesh):
        merged.update(part)
    return [merged[i] for i in sorted(merged)]


def gather_objects(obj, mesh: Optional[Mesh], axis: Optional[str] = None) -> Optional[list]:
    """Every rank's picklable `obj` in rank order on the group's first rank,
    None on the others; [obj] without a process group."""
    group = None if mesh is None else mesh.group(axis)
    if group is None:
        return [obj]
    first = dist.get_global_rank(group, 0)
    out = [None] * dist.get_world_size(group) if dist.get_rank() == first else None
    dist.gather_object(obj, out, dst=first, group=group)
    return out


def broadcast_object(obj, mesh: Optional[Mesh], axis: Optional[str] = None):
    """Rank 0's picklable `obj` on every rank (the others pass anything)."""
    group = None if mesh is None else mesh.group(axis)
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0), group=group)
    return box[0]


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank (nothing without a process group)."""
    group = None if mesh is None else mesh.group()
    if group is not None:
        dist.barrier(group=group)


def is_main(mesh: Optional[Mesh]) -> bool:
    """Whether this rank does the rank-0-only work (files, printing)."""
    return mesh is None or mesh.rank == 0


def stride(n: int, mesh: Optional[Mesh]) -> range:
    """The indices of n items (batches, rows of a sweep) this rank takes:
    every rows-th from its row; all of them with one rank."""
    if mesh is None:
        return range(n)
    return range(mesh.row, n, mesh.rows)
