"""Rectified-flow schedule and Euler step (port of
``avatar_tpu/diffusion/rf.py``).

The forward process is x_t = (1 - t) x0 + t eps and the model predicts
v = eps - x0. The schedule is host-side numpy; the step is a tensor
function.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Union

import numpy as np
import torch

T_EPS = 1e-6


def linear_quadratic_schedule(
    num_steps: int,
    threshold_noise: float = 0.025,
    linear_steps: Optional[int] = None,
) -> np.ndarray:
    """Linear-then-quadratic sigma schedule."""
    if num_steps == 1:
        return np.asarray([1.0], dtype=np.float64)
    if linear_steps is None:
        linear_steps = num_steps // 2
    linear = [i * threshold_noise / linear_steps for i in range(linear_steps)]
    step_diff = linear_steps - threshold_noise * num_steps
    quadratic_steps = num_steps - linear_steps
    quadratic_coef = step_diff / (linear_steps * quadratic_steps**2)
    linear_coef = threshold_noise / linear_steps - 2 * step_diff / (
        quadratic_steps**2)
    const = quadratic_coef * (linear_steps**2)
    quadratic = [
        quadratic_coef * (i**2) + linear_coef * i + const
        for i in range(linear_steps, num_steps)
    ]
    sigma = [1.0 - x for x in linear + quadratic + [1.0]]
    return np.asarray(sigma[:-1], dtype=np.float64)


def time_shift(mu: float, sigma: float, t: Union[np.ndarray, float]) -> np.ndarray:
    """t' = e^mu / (e^mu + (1/t - 1)^sigma)."""
    t = np.asarray(t, dtype=np.float64)
    return math.exp(mu) / (math.exp(mu) + (1.0 / t - 1.0) ** sigma)


def get_normal_shift(
    n_tokens: int,
    min_tokens: int = 1024,
    max_tokens: int = 4096,
    min_shift: float = 0.95,
    max_shift: float = 2.05,
) -> float:
    """Token-count-linear mu for the SD3 shift."""
    m = (max_shift - min_shift) / (max_tokens - min_tokens)
    return m * n_tokens + (min_shift - m * min_tokens)


def strech_shifts_to_terminal(shifts: np.ndarray, terminal: float = 0.1) -> np.ndarray:
    """Rescale shifted timesteps so the last one equals ``terminal``."""
    if shifts.size == 0:
        raise ValueError("The 'shifts' array must not be empty.")
    if terminal <= 0 or terminal >= 1:
        raise ValueError("The terminal value must be in (0, 1).")
    one_minus_z = 1.0 - shifts
    scale_factor = one_minus_z[-1] / (1.0 - terminal)
    if scale_factor == 0.0:
        # single step ending at t=1: the stretch is undefined; keep shifts
        return shifts
    return 1.0 - (one_minus_z / scale_factor)


def _token_count_from_shape(samples_shape: Sequence[int]) -> int:
    if len(samples_shape) == 3:
        return int(samples_shape[1])
    if len(samples_shape) in (4, 5):
        return int(np.prod(samples_shape[2:]))
    raise ValueError(
        "Samples must have shape (b, t, c), (b, c, h, w) or (b, c, f, h, w)")


def sd3_resolution_dependent_timestep_shift(
    samples_shape: Sequence[int],
    timesteps: np.ndarray,
    target_shift_terminal: Optional[float] = None,
) -> np.ndarray:
    shifted = time_shift(get_normal_shift(_token_count_from_shape(samples_shape)),
                         1.0, timesteps)
    if target_shift_terminal is not None:
        shifted = strech_shifts_to_terminal(shifted, target_shift_terminal)
    return shifted


def simple_diffusion_resolution_dependent_timestep_shift(
    samples_shape: Sequence[int],
    timesteps: np.ndarray,
    n: int = 32 * 32,
) -> np.ndarray:
    m = _token_count_from_shape(samples_shape)
    t = np.asarray(timesteps, dtype=np.float64)
    snr = (t / (1.0 - t)) ** 2
    shift_snr = np.log(snr) + 2.0 * math.log(m / n)
    return 1.0 / (1.0 + np.exp(-0.5 * shift_snr))


def make_sigmas(
    num_steps: int,
    sampler: str = "Uniform",
    shift: Optional[float] = None,
) -> np.ndarray:
    """Initial (unshifted) sigma schedule."""
    if sampler == "Uniform":
        return np.linspace(1.0, 1.0 / num_steps, num_steps, dtype=np.float64)
    if sampler == "LinearQuadratic":
        return linear_quadratic_schedule(num_steps)
    if sampler == "Constant":
        if shift is None:
            raise ValueError("Shift must be provided for Constant sampler.")
        return time_shift(shift, 1.0, np.linspace(
            1.0, 1.0 / num_steps, num_steps, dtype=np.float64))
    raise ValueError(f"Unknown sampler: {sampler}")


def shift_timesteps(
    timesteps: np.ndarray,
    samples_shape: Optional[Sequence[int]] = None,
    shifting: Optional[str] = None,
    target_shift_terminal: Optional[float] = None,
    base_resolution: int = 32 * 32,
) -> np.ndarray:
    """Resolution-dependent timestep shift dispatch."""
    if shifting == "SD3":
        return sd3_resolution_dependent_timestep_shift(
            samples_shape, timesteps, target_shift_terminal)
    if shifting == "SimpleDiffusion":
        return simple_diffusion_resolution_dependent_timestep_shift(
            samples_shape, timesteps, base_resolution)
    return timesteps


@dataclass(frozen=True)
class RectifiedFlowSchedule:
    """Immutable schedule: descending sigmas in (0, 1] plus the metadata
    of the reference scheduler config."""

    sigmas: np.ndarray
    num_train_timesteps: int = 1000
    shifting: Optional[str] = None
    target_shift_terminal: Optional[float] = None
    base_resolution: int = 32 * 32
    sampler: str = "Uniform"
    shift: Optional[float] = None

    @classmethod
    def create(
        cls,
        num_train_timesteps: int = 1000,
        sampler: str = "Uniform",
        shifting: Optional[str] = None,
        target_shift_terminal: Optional[float] = None,
        base_resolution: int = 32 * 32,
        shift: Optional[float] = None,
    ) -> "RectifiedFlowSchedule":
        return cls(
            sigmas=make_sigmas(num_train_timesteps, sampler, shift),
            num_train_timesteps=num_train_timesteps,
            shifting=shifting,
            target_shift_terminal=target_shift_terminal,
            base_resolution=base_resolution,
            sampler=sampler,
            shift=shift,
        )

    @classmethod
    def from_config(cls, config: dict) -> "RectifiedFlowSchedule":
        """Build from a reference-format scheduler config dict."""
        return cls.create(
            num_train_timesteps=config.get("num_train_timesteps", 1000),
            sampler=config.get("sampler", "Uniform") or "Uniform",
            shifting=config.get("shifting"),
            target_shift_terminal=config.get("target_shift_terminal"),
            base_resolution=config.get("base_resolution") or 32 * 32,
            shift=config.get("shift"),
        )

    def set_timesteps(
        self,
        num_inference_steps: Optional[int] = None,
        samples_shape: Optional[Sequence[int]] = None,
        timesteps: Optional[np.ndarray] = None,
    ) -> "RectifiedFlowSchedule":
        """A new schedule restricted to the inference steps."""
        if timesteps is not None and num_inference_steps is not None:
            raise ValueError("Provide either `timesteps` or `num_inference_steps`.")
        if timesteps is None:
            n = min(self.num_train_timesteps, num_inference_steps)
            t = shift_timesteps(
                make_sigmas(n, self.sampler, self.shift),
                samples_shape=samples_shape,
                shifting=self.shifting,
                target_shift_terminal=self.target_shift_terminal,
                base_resolution=self.base_resolution,
            )
        else:
            t = np.asarray(timesteps, dtype=np.float64)
        return RectifiedFlowSchedule(
            sigmas=t,
            num_train_timesteps=self.num_train_timesteps,
            shifting=self.shifting,
            target_shift_terminal=self.target_shift_terminal,
            base_resolution=self.base_resolution,
            sampler=self.sampler,
            shift=self.shift,
        )


def add_noise(
    original_samples: torch.Tensor,
    noise: torch.Tensor,
    timesteps: torch.Tensor,
) -> torch.Tensor:
    """x_t = (1 - t) x0 + t eps, with t broadcast over trailing dims."""
    t = torch.as_tensor(timesteps, device=original_samples.device)
    t = t.reshape(t.shape + (1,) * (original_samples.ndim - t.ndim))
    return (1.0 - t) * original_samples + t * noise


def velocity_target(
    tokens: torch.Tensor,
    noise: torch.Tensor,
    t: torch.Tensor,  # noqa: ARG001 - the RF velocity does not depend on t
) -> torch.Tensor:
    """The training target v = d x_t / dt = -x0 + eps."""
    return -tokens + noise


def rf_step(
    sigmas: torch.Tensor,
    model_output: torch.Tensor,
    timestep: torch.Tensor,
    sample: torch.Tensor,
    stochastic_sampling: bool = False,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One Euler step z <- z - dt * v, where dt runs from ``timestep`` down
    to the largest schedule value strictly below it. ``timestep`` is a
    scalar or per-token [B, N] (``sample`` is then [B, N, C]); it need not
    be a member of ``sigmas``. Sigmas and timestep are cast to the sample
    dtype first (in bf16 the ``- T_EPS`` then rounds away, as in the JAX
    package).

    ``stochastic_sampling`` re-noises the predicted x0 to the next level
    instead: (1 - t_next) x0 + t_next eps, with eps = ``noise`` or one draw
    from ``generator`` (one of the two is required).
    """
    dtype, device = sample.dtype, sample.device
    sigmas = torch.as_tensor(sigmas, device=device).to(dtype)
    timestep = torch.as_tensor(timestep, device=device).to(dtype)
    padded = torch.cat([sigmas, sigmas.new_zeros(1)])
    if timestep.ndim == 0:
        lower = torch.where(padded < (timestep - T_EPS), padded,
                            padded.new_zeros(())).amax()
        dt = timestep - lower
        t_full = timestep
    else:
        if timestep.ndim != 2:
            raise ValueError("per-token timestep must be [B, N]")
        levels = padded[:, None, None]
        lower = torch.where(levels < (timestep[None] - T_EPS), levels,
                            levels.new_zeros(())).amax(dim=0)
        dt = (timestep - lower)[..., None]
        t_full = timestep[..., None]
    if not stochastic_sampling:
        return sample - dt * model_output
    if noise is None:
        if generator is None:
            raise ValueError("stochastic sampling needs a generator or noise")
        noise = torch.randn(sample.shape, generator=generator, device=device,
                            dtype=torch.float32)
    x0 = sample - t_full * model_output
    return add_noise(x0, noise.to(device, dtype), t_full - dt)
