"""Sound-source-localization coordinate transforms (counterpart of
``spiking_fullsubnet_tpu/dsp/sslt.py``; reference
audiozen/acoustics/sslt.py), on tensors."""

from __future__ import annotations

import torch


def cart2sph(cart: torch.Tensor, include_r: bool = False):
    """Cartesian ``[B, 2|3, T]`` -> spherical (sslt.py:5-46): 3-D ``[x, y,
    z]`` -> ``[B, T, 2]`` (theta, phi) or ``[B, T, 3]`` with r; 2-D ``[x, y]``
    -> phi ``[B, T]`` or ``[B, T, 2]`` (phi, r)."""
    num_coordinates = cart.shape[1]
    if num_coordinates not in (2, 3):
        raise ValueError("Only support 2D or 3D coordinates.")
    radius = torch.sqrt(torch.sum(torch.square(cart), dim=1))
    phi = torch.atan2(cart[:, 1, :], cart[:, 0, :])
    if num_coordinates == 2:
        return torch.stack((phi, radius), dim=-1) if include_r else phi
    theta = torch.acos(cart[:, 2, :] / radius)
    if include_r:
        return torch.stack((theta, phi, radius), dim=-1)
    return torch.stack((theta, phi), dim=-1)


def sph2cart(sph: torch.Tensor) -> torch.Tensor:
    """Spherical ``[B, 1|2, T]`` -> unit cartesian ``[B, 2|3, T]`` (sslt.py:48-82)."""
    num_coordinates = sph.shape[1]
    if num_coordinates not in (1, 2):
        raise ValueError("Only support 1D or 2D coordinates now.")
    if num_coordinates == 1:
        return torch.stack((torch.cos(sph[:, 0, :]), torch.sin(sph[:, 0, :])), dim=1)
    x = torch.sin(sph[:, 0, :]) * torch.cos(sph[:, 1, :])
    y = torch.sin(sph[:, 0, :]) * torch.sin(sph[:, 1, :])
    z = torch.cos(sph[:, 0, :])
    return torch.stack((x, y, z), dim=1)
