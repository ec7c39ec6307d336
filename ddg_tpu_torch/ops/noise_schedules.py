"""Noise schedules for discrete diffusion (port of
`ddg_tpu/ops/noise_schedules.py`).

Each schedule is a frozen dataclass of static Python floats whose methods
map a time tensor t in [0, 1] to sigma(t) (the integrated noise, "total
noise") or dsigma/dt ("rate noise"). alpha(t) = exp(-sigma(t)) is the
keep-probability of the forward process. Python floats are accepted and
promoted to float32 tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch


def _t(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x if x.is_floating_point() else x.float()
    return torch.as_tensor(x, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    """Base class. Subclasses implement total_noise / rate_noise."""

    def total_noise(self, t):
        raise NotImplementedError

    def rate_noise(self, t):
        raise NotImplementedError

    def inverse_total_noise(self, sigma):
        """t such that total_noise(t) == sigma (the first-hitting
        sampler maps move-chance quantiles to decode times with it)."""
        raise NotImplementedError

    def __call__(self, t) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.total_noise(t), self.rate_noise(t)

    @property
    def sigma_min(self) -> float:
        raise NotImplementedError

    @property
    def sigma_max(self) -> float:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class LogLinearNoise(NoiseSchedule):
    """sigma(t) = -log1p(-(1 - eps) * t): the move chance
    1 - exp(-sigma(t)) = (1 - eps) * t is linear in t."""

    eps: float = 1e-3

    def rate_noise(self, t):
        t = _t(t)
        return (1 - self.eps) / (1 - (1 - self.eps) * t)

    def total_noise(self, t):
        return -torch.log1p(-(1 - self.eps) * _t(t))

    def inverse_total_noise(self, sigma):
        return -torch.expm1(-_t(sigma)) / (1 - self.eps)

    @property
    def sigma_min(self) -> float:
        return self.eps

    @property
    def sigma_max(self) -> float:
        return -math.log1p(-(1 - self.eps))

    def importance_sampling_transformation(self, t):
        f_t = math.log1p(-math.exp(-self.sigma_max))
        f_0 = math.log1p(-math.exp(-self.sigma_min))
        t = _t(t)
        sigma_t = -torch.log1p(-torch.exp(t * f_t + (1 - t) * f_0))
        return -torch.expm1(-sigma_t) / (1 - self.eps)


@dataclasses.dataclass(frozen=True)
class LinearNoise(NoiseSchedule):
    """sigma(t) = sigma_min + t * (sigma_max - sigma_min)."""

    sigma_min_val: float = 0.0
    sigma_max_val: float = 10.0

    def rate_noise(self, t):
        return torch.full_like(_t(t),
                               self.sigma_max_val - self.sigma_min_val)

    def total_noise(self, t):
        return self.sigma_min_val + _t(t) * (
            self.sigma_max_val - self.sigma_min_val)

    def inverse_total_noise(self, sigma):
        return (_t(sigma) - self.sigma_min_val) / (
            self.sigma_max_val - self.sigma_min_val)

    @property
    def sigma_min(self) -> float:
        return self.sigma_min_val

    @property
    def sigma_max(self) -> float:
        return self.sigma_max_val

    def importance_sampling_transformation(self, t):
        f_t = math.log1p(-math.exp(-self.sigma_max_val))
        f_0 = (math.log1p(-math.exp(-self.sigma_min_val))
               if self.sigma_min_val > 0 else -float('inf'))
        t = _t(t)
        sigma_t = -torch.log1p(-torch.exp(t * f_t + (1 - t) * f_0))
        return (sigma_t - self.sigma_min_val) / (
            self.sigma_max_val - self.sigma_min_val)


@dataclasses.dataclass(frozen=True)
class GeometricNoise(NoiseSchedule):
    sigma_min_val: float = 1e-3
    sigma_max_val: float = 1.0

    def rate_noise(self, t):
        t = _t(t)
        return (self.sigma_min_val ** (1 - t) * self.sigma_max_val ** t
                * (math.log(self.sigma_max_val)
                   - math.log(self.sigma_min_val)))

    def total_noise(self, t):
        t = _t(t)
        return self.sigma_min_val ** (1 - t) * self.sigma_max_val ** t

    def inverse_total_noise(self, sigma):
        lo = math.log(self.sigma_min_val)
        hi = math.log(self.sigma_max_val)
        return (torch.log(_t(sigma)) - lo) / (hi - lo)

    @property
    def sigma_min(self) -> float:
        return self.sigma_min_val

    @property
    def sigma_max(self) -> float:
        return self.sigma_max_val


@dataclasses.dataclass(frozen=True)
class CosineNoise(NoiseSchedule):
    eps: float = 1e-3

    def rate_noise(self, t):
        t = _t(t)
        cos = (1 - self.eps) * torch.cos(t * math.pi / 2)
        sin = (1 - self.eps) * torch.sin(t * math.pi / 2)
        return (math.pi / 2) * sin / (cos + self.eps)

    def total_noise(self, t):
        cos = torch.cos(_t(t) * math.pi / 2)
        return -torch.log(self.eps + (1 - self.eps) * cos)

    def inverse_total_noise(self, sigma):
        cos = (torch.exp(-_t(sigma)) - self.eps) / (1 - self.eps)
        return torch.arccos(torch.clamp(cos, -1.0, 1.0)) * 2 / math.pi

    @property
    def sigma_min(self) -> float:
        return -math.log(self.eps + (1 - self.eps))

    @property
    def sigma_max(self) -> float:
        return -math.log(self.eps)


@dataclasses.dataclass(frozen=True)
class CosineSqrNoise(NoiseSchedule):
    eps: float = 1e-3

    def rate_noise(self, t):
        t = _t(t)
        cos = (1 - self.eps) * torch.cos(t * math.pi / 2) ** 2
        sin = (1 - self.eps) * torch.sin(t * math.pi)
        return (math.pi / 2) * sin / (cos + self.eps)

    def total_noise(self, t):
        cos = torch.cos(_t(t) * math.pi / 2) ** 2
        return -torch.log(self.eps + (1 - self.eps) * cos)

    def inverse_total_noise(self, sigma):
        cos2 = (torch.exp(-_t(sigma)) - self.eps) / (1 - self.eps)
        cos = torch.sqrt(torch.clamp(cos2, 0.0, 1.0))
        return torch.arccos(torch.clamp(cos, -1.0, 1.0)) * 2 / math.pi

    @property
    def sigma_min(self) -> float:
        return -math.log(self.eps + (1 - self.eps))

    @property
    def sigma_max(self) -> float:
        return -math.log(self.eps)


def get_noise(noise_type: str, sigma_min: float = 1e-4,
              sigma_max: float = 20.0) -> NoiseSchedule:
    """Schedule by name, as `ddg_tpu.ops.noise_schedules.get_noise`."""
    if noise_type == 'loglinear':
        return LogLinearNoise()
    if noise_type == 'linear':
        return LinearNoise(sigma_min, sigma_max)
    if noise_type == 'geometric':
        return GeometricNoise(sigma_min, sigma_max)
    if noise_type == 'cosine':
        return CosineNoise()
    if noise_type == 'cosinesqr':
        return CosineSqrNoise()
    raise NotImplementedError(
        f'{noise_type} noise schedule is not implemented.')
