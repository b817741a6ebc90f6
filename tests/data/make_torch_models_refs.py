"""Write the JAX renders of tests/test_models.py's small presets, which
the PyTorch port's renders are held to (``tests/torch_port_util.py``
MODEL_CASES and MODEL_REFS), one ``tests/data/torch_models_<case>_jax_ref.npz``
each, holding the image and, under ``case``, how it was rendered (JSON:
the integrator, the preset and its keywords, the size, the RenderOptions
fields and the seed):

- terrain: ``terrain(24, 24, nx=12, nz=12)``, 288 triangles;
- showcase: ``sphere_showcase(16, 16, nu=16, nv=16)``, 516 triangles;

each with the path tracer at 2 spp, max_depth 3, seed 0, on the JAX
package's CPU route (its XLA Moller-Trumbore intersection).

    JAX_PLATFORMS=cpu python tests/data/make_torch_models_refs.py [name ...]

tests/test_torch_models.py checks that each stored image equals a fresh
JAX render and holds the port's renders to it.
"""
import os
import sys

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]

from torch_port_util import (MODEL_REFS, jax_model_render,  # noqa: E402
                             model_case)

if __name__ == "__main__":
    for name in sys.argv[1:] or list(MODEL_REFS):
        path = MODEL_REFS[name]
        img = jax_model_render(name)
        np.savez(path, image=img, case=model_case(name))
        print(f"wrote {path}: shape {img.shape}, mean {img.mean():.6f}")
