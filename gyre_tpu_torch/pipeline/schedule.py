"""Diffusion noise schedules and sigma-space conversions.

Counterpart of gyre_tpu/pipeline/schedule.py. Everything here is host-side
numpy: ramps depend only on step counts and options, never on data, and the
samplers step through them as Python floats.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DiffusionSchedule:
    """Training-time noise schedule (the model's beta schedule)."""

    alphas_cumprod: np.ndarray           # [T] float64
    prediction_type: str = "epsilon"     # "epsilon" | "v_prediction"

    @property
    def num_train_timesteps(self) -> int:
        return len(self.alphas_cumprod)

    @property
    def sigmas(self) -> np.ndarray:
        ac = self.alphas_cumprod
        return np.sqrt((1.0 - ac) / ac)

    @property
    def log_sigmas(self) -> np.ndarray:
        return np.log(self.sigmas)

    @property
    def sigma_min(self) -> float:
        return float(self.sigmas[0])

    @property
    def sigma_max(self) -> float:
        return float(self.sigmas[-1])


def scaled_linear_schedule(num_timesteps: int = 1000,
                           beta_start: float = 0.00085,
                           beta_end: float = 0.012,
                           prediction_type: str = "epsilon"
                           ) -> DiffusionSchedule:
    """The SD family's "scaled_linear" beta schedule."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_timesteps,
                        dtype=np.float64) ** 2
    return DiffusionSchedule(alphas_cumprod=np.cumprod(1.0 - betas),
                             prediction_type=prediction_type)


def t_to_sigma_np(schedule: DiffusionSchedule, t) -> np.ndarray:
    """Fractional timestep -> sigma by log-space interpolation."""
    log_sigmas = schedule.log_sigmas
    t = np.asarray(t, np.float64)
    low = np.floor(t).astype(int).clip(0, len(log_sigmas) - 1)
    high = np.ceil(t).astype(int).clip(0, len(log_sigmas) - 1)
    w = t - low
    return np.exp((1 - w) * log_sigmas[low] + w * log_sigmas[high])


def sigma_to_t(log_sigmas: np.ndarray, sigma: float) -> float:
    """sigma -> fractional timestep (for UNet conditioning)."""
    return float(np.interp(np.log(sigma), log_sigmas,
                           np.arange(len(log_sigmas), dtype=np.float64)))


def karras_ramp(sigma_min: float, sigma_max: float, steps: int,
                rho: float = 7.0) -> np.ndarray:
    """Karras et al. (2022) rho-spaced sigma ramp, descending, 0-terminated."""
    ramp = np.linspace(0, 1, steps)
    inv_rho = 1.0 / rho
    sigmas = (sigma_max ** inv_rho +
              ramp * (sigma_min ** inv_rho - sigma_max ** inv_rho)) ** rho
    return np.append(sigmas, 0.0)


def build_sigmas(schedule: DiffusionSchedule, steps: int, *,
                 karras_rho: float | None = None,
                 sigma_min: float | None = None,
                 sigma_max: float | None = None,
                 spacing: str = "linspace") -> np.ndarray:
    """The txt2img sigma ramp for a request: [steps + 1] descending, last
    0. The JAX package's grids: k-diffusion "linspace" (interpolated
    fractional timesteps), the diffusers "leading" integer grid, or karras.
    (img2img's truncated ramps and dpm_fast's uniform-lambda ramp wait for
    their modes and sampler.)"""
    smin = sigma_min if sigma_min else schedule.sigma_min
    smax = sigma_max if sigma_max else schedule.sigma_max
    if karras_rho:
        return karras_ramp(smin, smax, steps, karras_rho)
    if spacing == "leading":
        ratio = max(1, schedule.num_train_timesteps // steps)
        t = np.minimum((np.arange(steps) * ratio).round()[::-1] + 1,
                       schedule.num_train_timesteps - 1).astype(np.float64)
    else:
        t = np.linspace(schedule.num_train_timesteps - 1, 0.0, steps)
    return np.append(t_to_sigma_np(schedule, t), 0.0)
