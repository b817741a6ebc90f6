"""ASCII PPM (P3) read/write, plus PNG convenience output.

The port of ``tuturenderer_tpu/io/ppm.py``, host-side numpy: loadTexture
parses P3 with values normalized by the max field (PPMGenerator.hpp:
1027-1084); generate/writePixel emit P3 with clamp + gamma 0.78
quantization (PPMGenerator.hpp:140-160, 804-845). NaN/inf pixels are
reported like writePixel does (PPMGenerator.hpp:819-823).

PIL is imported inside the two PNG functions only: nothing on the render
path reads or writes PNG.
"""
from __future__ import annotations

import numpy as np

from ..options import GAMMA_VAL


def read_ppm(path: str) -> np.ndarray:
    """-> float32 [H, W, 3] in [0, 1]."""
    with open(path, "r") as f:
        tokens = f.read().split()
    if tokens[0] != "P3":
        raise ValueError(f"{path}: expected P3 header")
    w = int(tokens[1])
    h = int(tokens[2])
    maxv = float(tokens[3])
    data = np.asarray(tokens[4:4 + w * h * 3], dtype=np.float32)
    return (data / maxv).reshape(h, w, 3)


def read_png(path: str) -> np.ndarray:
    """-> float32 [H, W, 3] in [0, 1]."""
    from PIL import Image
    arr = np.asarray(Image.open(path).convert("RGB"), np.float32)
    return arr / 255.0


def quantize(img: np.ndarray, gamma: float = GAMMA_VAL) -> np.ndarray:
    """Linear [H,W,3] -> uint8 with the reference's clamp+gamma transform
    (PPMGenerator.hpp:825-842)."""
    bad = ~np.isfinite(img)
    if bad.any():
        ys, xs = np.nonzero(bad.any(axis=2))[:2]
        for y, x in list(zip(ys, xs))[:16]:
            print(f"{x}, {y} is nan/inf")
        img = np.nan_to_num(img, nan=0.0, posinf=1.0, neginf=0.0)
    out = 255.0 * np.clip(img, 0.0, 1.0) ** gamma
    return out.astype(np.uint8)


def write_ppm(path: str, img: np.ndarray, gamma: float = GAMMA_VAL) -> None:
    q = quantize(np.asarray(img), gamma)
    h, w, _ = q.shape
    with open(path, "w") as f:
        f.write(f"P3\n{w}\n{h}\n255\n")
        flat = q.reshape(-1, 3)
        f.write("\n".join(f"{r} {g} {b}" for r, g, b in flat))
        f.write("\n")


def write_png(path: str, img: np.ndarray, gamma: float = GAMMA_VAL) -> None:
    from PIL import Image
    Image.fromarray(quantize(np.asarray(img), gamma)).save(path)
