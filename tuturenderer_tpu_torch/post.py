"""Post-processing: bloom (emissive extract + separable Gaussian) and
exposure tone-mapping.

The port of ``tuturenderer_tpu/post.py``, which re-implements
Postprocessor (Postprocessor.hpp:29-197):

- emissive extraction: pixels with |rgb| > 3 rescaled so their max channel
  hits STRENGTH=2 (Postprocessor.hpp:122-148);
- separable Gaussian blur with KERNELSIZE=10 taps, STDDEV=30, repeated
  GAUSSIANLOOP+1 times (Postprocessor.hpp:37-45, 63-119), clamp-to-edge
  like its UV clamp;
- add back and exposure map 1 - exp(-c * EXPOSURE) (Postprocessor.hpp:
  150-166, 173-197).

The JAX module is plain ``jnp`` under ``jax.jit``, with no Pallas kernel,
so its port is plain torch and has no hand-written kernel. Every function
takes and returns a float32 [H, W, 3] tensor (a numpy array is taken too)
and computes on the image's own device.
"""
from __future__ import annotations

import numpy as np
import torch

STRENGTH = 2.0
GAUSSIANLOOP = 1
KERNELSIZE = 10
STDDEV = 30.0
EXPOSURE = 1.5


def _as_tensor(img) -> torch.Tensor:
    return torch.as_tensor(img, dtype=torch.float32)


def _gaussian_kernel(size: int = KERNELSIZE, stddev: float = STDDEV):
    """(normalised float32 taps, first tap's offset). The taps sit at
    start..start+size-1 with start = -size*0.5 truncated like the C int
    conversion (Postprocessor.hpp:83)."""
    start = int(-size * 0.5)
    xs = np.arange(start, start + size, dtype=np.float64)
    g = (1.0 / np.sqrt(2 * np.pi * stddev)) * np.exp(
        -(xs * xs) / (2 * stddev * stddev))
    g = g / g.sum()
    return torch.from_numpy(g.astype(np.float32)), start


def _blur_axis(img: torch.Tensor, axis: int) -> torch.Tensor:
    k, start = _gaussian_kernel()
    k = k.tolist()
    out = torch.zeros_like(img)
    n = img.shape[axis]
    idx_base = torch.arange(n, device=img.device)
    for i in range(KERNELSIZE):
        idx = torch.clamp(idx_base + (start + i), 0, n - 1)   # clamp-to-edge
        out = out + k[i] * torch.index_select(img, axis, idx)
    return out


def extract_emissive(img) -> torch.Tensor:
    img = _as_tensor(img)
    mag = torch.sqrt(torch.sum(img * img, dim=-1, keepdim=True))
    mx = torch.amax(img, dim=-1, keepdim=True)
    rescaled = img / torch.clamp(mx, min=1e-20) * STRENGTH
    return torch.where(mag > 3.0, rescaled, 0.0)


def gaussian_blur(img) -> torch.Tensor:
    return _blur_axis(_blur_axis(_as_tensor(img), 0), 1)


def tonemap_exposure(img) -> torch.Tensor:
    return 1.0 - torch.exp(-_as_tensor(img) * EXPOSURE)


def bloom_only(img) -> torch.Tensor:
    img = _as_tensor(img)
    em = extract_emissive(img)
    for _ in range(GAUSSIANLOOP + 1):
        em = gaussian_blur(em)
    return img + em


def bloom_and_tonemap(img) -> torch.Tensor:
    """HDR_BLOOM pipeline (Postprocessor.hpp:29-59): bloom then tone map."""
    return tonemap_exposure(bloom_only(img))


def hdr_only(img) -> torch.Tensor:
    return tonemap_exposure(img)
