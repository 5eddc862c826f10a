"""Multi-boundary consistency solver math and the inference timestep grids.

PyTorch counterpart of `invertible_cd_tpu/diffusion/solver.py`
(`predicted_origin`, `SolverGrid`, `make_solver_grid`). The grids are host
numpy ints; the hop math is elementwise tensor code.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .schedule import ddim_timestep_grid, extract


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
