"""Write tests/data/torch_simple_box_jax_ref.npy: the JAX package's render
of simple_box(24, 20) at 4 spp, seed 3, with its dense Pallas kernels in
interpret mode on the CPU.

    JAX_PLATFORMS=cpu python tests/data/make_torch_simple_box_ref.py

tests/test_torch_path.py checks that the stored image equals a fresh JAX
render, and chip_smoke.py holds the port's GPU render against it.
"""
import os
import sys

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]

from torch_port_util import REF_PATH, jax_reference_render  # noqa: E402

if __name__ == "__main__":
    img = jax_reference_render().astype(np.float32)
    np.save(REF_PATH, img)
    print(f"wrote {REF_PATH}: shape {img.shape}, mean {img.mean():.6f}")
