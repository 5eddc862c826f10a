"""Multi-boundary consistency solver math and the inference timestep grids.

PyTorch counterpart of `invertible_cd_tpu/diffusion/solver.py`
(`predicted_origin`, the DDIM steps `ddim_prev_step` / `ddim_next_step`
of the 50-step baselines, `SolverGrid`, `make_solver_grid`, and for training
`TrainSolver`, `make_train_solver`, `parse_endpoints`). The inference grids
are host numpy ints; the training solver's tables are tensors on one
device; the hop math is elementwise tensor code.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .schedule import NoiseSchedule, ddim_timestep_grid, extract


def predicted_origin(
    model_output: torch.Tensor,
    timesteps: torch.Tensor,
    boundary_timesteps: torch.Tensor,
    sample: torch.Tensor,
    alpha_schedule: torch.Tensor,
    sigma_schedule: torch.Tensor,
    prediction_type: str = "epsilon",
) -> torch.Tensor:
    """The consistency hop t -> s: x0-prediction followed by an Euler step to s.

    With the hard boundary alpha_s=1, sigma_s=0 wherever s == 0, so the
    multi-boundary model is exactly direct CD at the last hop.
    """
    ndim = sample.ndim
    sigma_s = extract(sigma_schedule, boundary_timesteps, ndim)
    alpha_s = extract(alpha_schedule, boundary_timesteps, ndim)
    sigma_t = extract(sigma_schedule, timesteps, ndim)
    alpha_t = extract(alpha_schedule, timesteps, ndim)

    is_zero = torch.as_tensor(boundary_timesteps, device=sample.device) == 0
    if is_zero.ndim > 0:
        is_zero = is_zero.reshape(is_zero.shape[0], *((1,) * (ndim - 1)))
    alpha_s = torch.where(is_zero, torch.ones_like(alpha_s), alpha_s)
    sigma_s = torch.where(is_zero, torch.zeros_like(sigma_s), sigma_s)

    if prediction_type == "epsilon":
        pred_x0 = (sample - sigma_t * model_output) / alpha_t
        return alpha_s * pred_x0 + sigma_s * model_output
    if prediction_type == "v_prediction":
        pred_x0 = alpha_t * sample - sigma_t * model_output
        pred_eps = sigma_t * sample + alpha_t * model_output
        return alpha_s * pred_x0 + sigma_s * pred_eps
    raise ValueError(f"Prediction type {prediction_type} not supported.")


# ---------------------------------------------------------------------------
# One-hop DDIM steps (the 50-step baseline loops)
# ---------------------------------------------------------------------------
def ddim_prev_step(
    model_output: torch.Tensor,
    timestep,
    sample: torch.Tensor,
    schedule: NoiseSchedule,
    step_ratio: int,
) -> torch.Tensor:
    """One reverse DDIM step t -> t - step_ratio (JAX `solver.py:74-92`);
    below t = 0 the previous alpha-cumprod is `final_alpha_cumprod`.
    `timestep`: a python int or a (B,) / scalar tensor."""
    timestep = torch.as_tensor(timestep, device=sample.device)
    prev_t = timestep - step_ratio
    acp = schedule.alphas_cumprod
    alpha_prod_t = extract(acp, timestep, sample.ndim)
    alpha_prod_prev = torch.where(
        _ge0(prev_t, sample.ndim),
        extract(acp, prev_t.clamp_min(0), sample.ndim),
        schedule.final_alpha_cumprod,
    )
    beta_prod_t = 1.0 - alpha_prod_t
    pred_x0 = (sample - beta_prod_t**0.5 * model_output) / alpha_prod_t**0.5
    direction = (1.0 - alpha_prod_prev) ** 0.5 * model_output
    return alpha_prod_prev**0.5 * pred_x0 + direction


def ddim_next_step(
    model_output: torch.Tensor,
    timestep,
    sample: torch.Tensor,
    schedule: NoiseSchedule,
    step_ratio: int,
) -> torch.Tensor:
    """One forward (inversion) DDIM step to `timestep` from
    min(timestep - step_ratio, T - 1) (JAX `solver.py:95-115`); below 0 the
    current alpha-cumprod is `final_alpha_cumprod`."""
    timestep = torch.as_tensor(timestep, device=sample.device)
    cur_t = (timestep - step_ratio).clamp_max(schedule.num_train_timesteps - 1)
    acp = schedule.alphas_cumprod
    alpha_prod_t = torch.where(
        _ge0(cur_t, sample.ndim),
        extract(acp, cur_t.clamp_min(0), sample.ndim),
        schedule.final_alpha_cumprod,
    )
    alpha_prod_next = extract(acp, timestep, sample.ndim)
    beta_prod_t = 1.0 - alpha_prod_t
    next_x0 = (sample - beta_prod_t**0.5 * model_output) / alpha_prod_t**0.5
    direction = (1.0 - alpha_prod_next) ** 0.5 * model_output
    return alpha_prod_next**0.5 * next_x0 + direction


def _ge0(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """t >= 0, shaped to broadcast over an `ndim`-D sample."""
    cond = t >= 0
    if cond.ndim == 0:
        return cond
    return cond.reshape(cond.shape[0], *((1,) * (ndim - 1)))


@dataclasses.dataclass(frozen=True)
class SolverGrid:
    """Static (timestep, boundary) pairs for the reverse and forward CD loops.

    reverse: noise -> image, iterate (t_i, s_i) with t descending.
    forward: image -> noise, iterate (t_i, s_i) with t ascending.
    All entries are host numpy int64.
    """

    reverse_timesteps: np.ndarray
    reverse_boundaries: np.ndarray
    forward_timesteps: np.ndarray
    forward_boundaries: np.ndarray
    ddim_timesteps: np.ndarray
    n_steps: int = 50
    start_timestep: int = 19

    @property
    def num_reverse_steps(self) -> int:
        return len(self.reverse_timesteps)

    @property
    def num_forward_steps(self) -> int:
        return len(self.forward_timesteps)


def _auto_endpoints(
    ddim_ts: np.ndarray, num_endpoints: int, n_steps: int, max_inverse_index: int
):
    """Evenly spread endpoints."""
    interval = n_steps // num_endpoints + int(n_steps % num_endpoints > 0)
    idxs = np.arange(interval, n_steps, interval) - 1
    inverse_idxs = np.concatenate([idxs, [max_inverse_index]])
    endpoints = np.concatenate([[0], ddim_ts[idxs]])
    inverse_endpoints = ddim_ts[inverse_idxs]
    return endpoints.astype(np.int64), inverse_endpoints.astype(np.int64)


def make_solver_grid(
    n_steps: int = 50,
    num_endpoints: int = 4,
    num_forward_endpoints: int = 4,
    reverse_timesteps: Sequence[int] | None = None,
    forward_timesteps: Sequence[int] | None = None,
    max_forward_timestep_index: int | None = None,
    start_timestep: int = 19,
    num_train_timesteps: int = 1000,
) -> SolverGrid:
    """Build the (t, s) pairs for both CD directions: either evenly spread
    endpoints or explicit timestep lists (reverse [259,519,779,999] ->
    t=[999,779,519,259], s=[779,519,259,0]; forward [19,259,519,779] ->
    s=[259,519,779,999])."""
    ddim_ts = ddim_timestep_grid(n_steps, num_train_timesteps)
    if max_forward_timestep_index is None:
        max_forward_timestep_index = n_steps - 1

    if reverse_timesteps is None or forward_timesteps is None:
        endpoints, inverse_endpoints = _auto_endpoints(
            ddim_ts, num_endpoints, n_steps, max_forward_timestep_index
        )
        rev_t, rev_s = inverse_endpoints[::-1].copy(), endpoints[::-1].copy()

        f_endpoints, f_inverse = _auto_endpoints(
            ddim_ts, num_forward_endpoints, n_steps, max_forward_timestep_index
        )
        fwd_t, fwd_s = f_endpoints.copy(), f_inverse.copy()
        fwd_t[0] = start_timestep
    else:
        rev_t = np.asarray(list(reverse_timesteps)[::-1], dtype=np.int64)
        rev_s = np.concatenate([rev_t[1:], [0]]).astype(np.int64)
        fwd_t = np.asarray(list(forward_timesteps), dtype=np.int64)
        fwd_s = np.concatenate([fwd_t[1:], [num_train_timesteps - 1]]).astype(np.int64)

    return SolverGrid(
        reverse_timesteps=rev_t,
        reverse_boundaries=rev_s,
        forward_timesteps=fwd_t,
        forward_boundaries=fwd_s,
        ddim_timesteps=ddim_ts,
        n_steps=n_steps,
        start_timestep=start_timestep,
    )


# ---------------------------------------------------------------------------
# Training-side solver
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TrainSolver:
    """DDIM solver tables + CD endpoints for the four training losses, as
    tensors on one device: `ddim_timesteps` with prev/next alpha-cumprod
    tables, and the reverse / forward endpoint lists that define the
    multi-boundary targets.
    """

    ddim_timesteps: torch.Tensor  # (N,) int64
    ddim_alpha_cumprods: torch.Tensor  # (N,) float32
    ddim_alpha_cumprods_prev: torch.Tensor  # (N,)
    ddim_alpha_cumprods_next: torch.Tensor  # (N,)  (last entry 0.0)
    endpoints: torch.Tensor  # (E,) int64, ascending, endpoints[0] == 0
    forward_endpoints: torch.Tensor  # (F,) int64, ascending, last == T-1

    def ddim_step(self, pred_x0, pred_noise, timestep_index):
        """x_{t-1} from (x0, eps) at ddim index."""
        acp_prev = extract(self.ddim_alpha_cumprods_prev, timestep_index, pred_x0.ndim)
        return torch.sqrt(acp_prev) * pred_x0 + torch.sqrt(1.0 - acp_prev) * pred_noise

    def forward_ddim_step(self, pred_x0, pred_noise, timestep_index):
        """x_{t+1} from (x0, eps) at ddim index."""
        acp_next = extract(self.ddim_alpha_cumprods_next, timestep_index, pred_x0.ndim)
        return torch.sqrt(acp_next) * pred_x0 + torch.sqrt(1.0 - acp_next) * pred_noise

    def reverse_boundaries_for(self, timesteps: torch.Tensor) -> torch.Tensor:
        """Boundary s for each t: the largest endpoint <= t."""
        le = timesteps[None, :] >= self.endpoints[:, None]  # (E, B)
        idx = le.sum(dim=0) - 1
        return self.endpoints[idx.clamp_min(0)]

    def forward_boundaries_for(self, timesteps: torch.Tensor) -> torch.Tensor:
        """Boundary s for each t: the smallest forward endpoint >= t."""
        ge = timesteps[None, :] <= self.forward_endpoints[:, None]  # (F, B)
        n = self.forward_endpoints.shape[0]
        idx = n - ge.sum(dim=0)
        return self.forward_endpoints[idx.clamp(0, n - 1)]


def parse_endpoints(spec: str | Sequence[int]) -> np.ndarray:
    """Parse "0,259,519,779"-style endpoint strings."""
    if isinstance(spec, str):
        return np.asarray([int(e) for e in spec.split(",")], dtype=np.int64)
    return np.asarray(list(spec), dtype=np.int64)


def make_train_solver(
    alphas_cumprod,
    num_train_timesteps: int = 1000,
    num_ddim_timesteps: int = 50,
    num_endpoints: int = 1,
    num_forward_endpoints: int = 1,
    endpoints: str | Sequence[int] | None = None,
    forward_endpoints: str | Sequence[int] | None = None,
    device="cpu",
) -> TrainSolver:
    """Build a TrainSolver on `device` from the schedule's alphas_cumprod
    (tensor or array); the tables are computed on the host in float64."""
    if isinstance(alphas_cumprod, torch.Tensor):
        alphas_cumprod = alphas_cumprod.detach().cpu().numpy()
    acp = np.asarray(alphas_cumprod, dtype=np.float64)
    ddim_ts = ddim_timestep_grid(num_ddim_timesteps, num_train_timesteps)
    acp_at = acp[ddim_ts]
    acp_prev = np.concatenate([[acp[0]], acp_at[:-1]])
    acp_next = np.concatenate([acp_at[1:], [0.0]])

    def spread(n: int) -> np.ndarray:
        interval = num_ddim_timesteps // n + int(num_ddim_timesteps % n > 0)
        return np.arange(interval, num_ddim_timesteps, interval) - 1

    if endpoints is None:
        ep = np.concatenate([[0], ddim_ts[spread(num_endpoints)]]).astype(np.int64)
    else:
        ep = parse_endpoints(endpoints)
        if len(ep) != num_endpoints:
            raise ValueError(f"{len(ep)} endpoints given, num_endpoints={num_endpoints}")
    if forward_endpoints is None:
        idxs = np.concatenate([spread(num_forward_endpoints), [num_ddim_timesteps - 1]])
        fep = ddim_ts[idxs].astype(np.int64)
    else:
        fep = parse_endpoints(forward_endpoints)
        if len(fep) != num_forward_endpoints:
            raise ValueError(
                f"{len(fep)} forward endpoints given, num_forward_endpoints={num_forward_endpoints}")

    def ints(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)

    def floats(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)

    return TrainSolver(
        ddim_timesteps=ints(ddim_ts),
        ddim_alpha_cumprods=floats(acp_at),
        ddim_alpha_cumprods_prev=floats(acp_prev),
        ddim_alpha_cumprods_next=floats(acp_next),
        endpoints=ints(ep),
        forward_endpoints=ints(fep),
    )
