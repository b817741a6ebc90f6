"""Write the JAX renders the mesh-scale slice of the PyTorch port is held
to, at 24x20, 4 spp, seed 3 (``tests/torch_port_util.py`` MESH_CASES and
MESH_REFS), one ``tests/data/torch_<case>_jax_ref.npz`` each, holding the
image and, under ``case``, how it was rendered (JSON: the integrator, the
scene preset and its keywords, the size, the RenderOptions fields and the
seed), so that chip_smoke.py renders the same case from the file alone:

- showcase_mis / showcase_nee: sphere_showcase(nu=46, nv=46), 4,236
  triangles, under the MIS and the NEE-only estimator (the JAX package's
  CPU route: its XLA BVH);
- translucent_alpha: the same geometry with the sphere's material at
  alpha 0.5, ``alpha_shadows=True``;
- box_nee / box_alpha: simple_box with ``mis=False`` and with
  ``alpha_shadows=True``, its dense Pallas kernels in interpret mode.

    JAX_PLATFORMS=cpu python tests/data/make_torch_mesh_refs.py

tests/test_torch_path.py checks that each stored image equals a fresh JAX
render, and chip_smoke.py holds the port's GPU renders against them.
"""
import os
import sys

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]

from torch_port_util import (MESH_REFS, jax_mesh_render,  # noqa: E402
                             mesh_case)

if __name__ == "__main__":
    for name in sys.argv[1:] or list(MESH_REFS):
        path = MESH_REFS[name]
        img = jax_mesh_render(name).astype(np.float32)
        np.savez(path, image=img, case=mesh_case(name))
        print(f"wrote {path}: shape {img.shape}, mean {img.mean():.6f}")
