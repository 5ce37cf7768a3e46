"""Diffusion samplers: Euler discrete (the SDXL default), DPM-Solver++(2M)
and (3M) (reference: seedx_tpu/models/sdxl/scheduler.py, whose docstring
derives the updates and records the solver studies).

The tables (``make_schedule``) are numpy, a copy of the JAX package's, so
the port imports nothing of it; keep the two identical.  The step
functions take tensors: the sample and the solver history in fp32, the
table entries as 0-d fp32 tensors (or Python numbers).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EulerScheduleConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    steps_offset: int = 1
    timestep_spacing: str = "leading"
    prediction_type: str = "epsilon"


@dataclasses.dataclass(frozen=True)
class EulerSchedule:
    """Precomputed tables for a fixed number of inference steps."""

    timesteps: np.ndarray      # [n] descending float
    sigmas: np.ndarray         # [n + 1] (last entry 0.0)
    init_noise_sigma: float
    solver: str = "euler"      # "euler" | "dpmpp_2m" | "dpmpp_3m"
    # DPM-Solver++ multistep tables (None for euler):
    r0: np.ndarray = None           # [n] h_prev/h per step (dummy 1.0 where 1st-order)
    second_order: np.ndarray = None  # [n] bool: use the multistep D1 correction
    # DPM-Solver++(3M) extras (None otherwise):
    r1: np.ndarray = None           # [n] h_prev2/h (dummy 1.0 where <3rd-order)
    c1: np.ndarray = None           # [n] D1 coefficient (h+r-1)/h
    c2: np.ndarray = None           # [n] D2 coefficient 1/2-(e^{-h}-1+h)/h^2
    order: np.ndarray = None        # [n] int32 per-step order in {1,2,3}

    @property
    def num_steps(self) -> int:
        return len(self.timesteps)


def karras_sigmas(sigma_min: float, sigma_max: float, n: int,
                  rho: float = 7.0) -> np.ndarray:
    """Karras et al. (arXiv:2206.00364 eq. 5) sigma ramp, descending, [n]."""
    ramp = np.linspace(0.0, 1.0, n, dtype=np.float64)
    inv = sigma_max ** (1.0 / rho) + ramp * (
        sigma_min ** (1.0 / rho) - sigma_max ** (1.0 / rho))
    return inv ** rho


def make_schedule(num_inference_steps: int,
                  cfg: EulerScheduleConfig = EulerScheduleConfig(),
                  solver: str = "euler",
                  karras: bool = None) -> EulerSchedule:
    n_train = cfg.num_train_timesteps
    if cfg.beta_schedule == "scaled_linear":
        betas = np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5,
                            n_train, dtype=np.float64) ** 2
    elif cfg.beta_schedule == "linear":
        betas = np.linspace(cfg.beta_start, cfg.beta_end, n_train,
                            dtype=np.float64)
    else:
        raise NotImplementedError(cfg.beta_schedule)
    alphas_cumprod = np.cumprod(1.0 - betas)
    sigmas_full = np.sqrt((1.0 - alphas_cumprod) / alphas_cumprod)

    if cfg.timestep_spacing == "leading":
        step_ratio = n_train // num_inference_steps
        timesteps = (np.arange(num_inference_steps) * step_ratio).round()
        timesteps = timesteps[::-1].astype(np.float64) + cfg.steps_offset
    elif cfg.timestep_spacing == "trailing":
        step_ratio = n_train / num_inference_steps
        timesteps = np.arange(n_train, 0, -step_ratio).round() - 1
        timesteps = timesteps.astype(np.float64)
    else:  # linspace
        timesteps = np.linspace(0, n_train - 1, num_inference_steps,
                                dtype=np.float64)[::-1]

    sigmas = np.interp(timesteps, np.arange(n_train), sigmas_full)

    if karras is None:
        karras = solver in ("dpmpp_2m", "dpmpp_3m")
    if karras:
        # Karras ramp over the model's full sigma range, then the
        # conditioning timesteps by log-sigma interpolation
        sigmas = karras_sigmas(float(sigmas_full[0]), float(sigmas_full[-1]),
                               num_inference_steps)
        timesteps = np.interp(np.log(sigmas), np.log(sigmas_full),
                              np.arange(n_train))

    sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)

    if karras or cfg.timestep_spacing in ("linspace", "trailing"):
        init_noise_sigma = float(sigmas.max())
    else:
        init_noise_sigma = float((sigmas.max() ** 2 + 1) ** 0.5)

    r0 = r1 = c1 = c2 = order = second = None
    if solver in ("dpmpp_2m", "dpmpp_3m"):
        sig = sigmas[:-1].astype(np.float64)
        n = len(sig)
        # h_i = log(sigma_i / sigma_{i+1}); the last step's h is infinite
        # (sigma -> 0) but that step is first-order
        h = np.ones(n)
        h[:-1] = np.log(sig[:-1] / sig[1:])
        h_prev = np.concatenate([[1.0], h[:-1]])
        r0 = (h_prev / h).astype(np.float32)
        second = np.zeros(n, bool)
        second[1:-1] = True
    if solver == "dpmpp_3m":
        h_prev2 = np.concatenate([[1.0, 1.0], h[:-2]]) if n > 2 else np.ones(n)
        r1 = (h_prev2 / h).astype(np.float32)
        r = sigmas[1:].astype(np.float64) / sig          # e^{-h}; 0 at last
        with np.errstate(divide="ignore", invalid="ignore"):
            c1 = ((h + r - 1.0) / h).astype(np.float32)
            c2 = (0.5 - (r - 1.0 + h) / (h * h)).astype(np.float32)
        order = np.minimum(np.arange(n) + 1, 3).astype(np.int32)
        order[-1] = 1                                    # final sigma -> 0
        if n >= 2 and num_inference_steps < 15:
            # diffusers lower_order_final: stabilize very short schedules
            order[-2] = min(order[-2], 2)
        # dummy-out coefficients where the order never uses them
        c1 = np.where(order >= 3, c1, 0.0).astype(np.float32)
        c2 = np.where(order >= 3, c2, 0.0).astype(np.float32)
    elif solver not in ("euler", "dpmpp_2m"):
        raise NotImplementedError(solver)

    return EulerSchedule(timesteps=timesteps.astype(np.float32),
                         sigmas=sigmas, init_noise_sigma=init_noise_sigma,
                         solver=solver, r0=r0, second_order=second,
                         r1=r1, c1=c1, c2=c2, order=order)


def scale_model_input(sample: torch.Tensor, sigma) -> torch.Tensor:
    """x / sqrt(sigma^2 + 1) (diffusers EulerDiscrete.scale_model_input)."""
    return sample / torch.sqrt(torch.as_tensor(sigma) ** 2 + 1.0)


def euler_step(sample: torch.Tensor, eps: torch.Tensor, sigma,
               sigma_next) -> torch.Tensor:
    """One Euler step, epsilon prediction, no churn: x' = x + eps (s' - s)."""
    return (sample.float() + eps.float() * (sigma_next - sigma)).to(
        sample.dtype)


def dpmpp_2m_step(sample: torch.Tensor, prev_x0: torch.Tensor,
                  eps: torch.Tensor, sigma, sigma_next, r0, use_second):
    """One DPM-Solver++(2M) update in Euler sigma-space: D0 = x0(sigma),
    D1 = (D0 - x0_prev) / r0, x' = r x + (1 - r)(D0 + D1 / 2) with
    r = sigma_next / sigma.  Returns (new sample, x0)."""
    x = sample.float()
    x0 = x - sigma * eps.float()
    d1 = (x0 - prev_x0) / r0
    d = torch.where(torch.as_tensor(use_second, device=x.device),
                    x0 + 0.5 * d1, x0)
    r = sigma_next / sigma
    return (r * x + (1.0 - r) * d).to(sample.dtype), x0


def dpmpp_3m_step(sample: torch.Tensor, m1: torch.Tensor, m2: torch.Tensor,
                  eps: torch.Tensor, sigma, sigma_next, r0, r1, c1, c2,
                  order):
    """One DPM-Solver++(3M) update in Euler sigma-space; m1 / m2 are the
    previous two x0 predictions (zeros until ``order`` uses them).
    Returns (new sample, m0, m1): the history shifted by one."""
    x = sample.float()
    m0 = x - sigma * eps.float()
    d1_0 = (m0 - m1) / r0
    d1_1 = (m1 - m2) / r1
    d1 = d1_0 + (r0 / (r0 + r1)) * (d1_0 - d1_1)
    d2 = (d1_0 - d1_1) / (r0 + r1)
    r = sigma_next / sigma
    first = r * x + (1.0 - r) * m0
    order = torch.as_tensor(order, device=x.device)
    out = torch.where(
        order >= 3, first + c1 * d1 + c2 * d2,
        torch.where(order == 2, first + (1.0 - r) * 0.5 * d1_0, first))
    return out.to(sample.dtype), m0, m1


def add_noise(original: torch.Tensor, noise: torch.Tensor,
              sigma) -> torch.Tensor:
    """Forward-noise a clean latent to noise level sigma (img2img entry)."""
    return original + noise * sigma
