"""Write the JAX gradients the differentiable slice of the PyTorch port is
held to (``tests/torch_port_util.py`` GRAD_CASES and GRAD_REFS), one
``tests/data/torch_grad_<case>_jax_ref.npz`` each, holding the scene and
camera tables (``scene.*``, ``camera.*``, as ``scene_from_numpy`` and
``camera_from_numpy`` take them), the image of the case's renderer and the
gradient of its mean for every MaterialParams leaf (``grad.diffuse.x``,
...), and, under ``case``, how it was computed (JSON: the renderer, the
scene, the camera size, the RenderOptions fields and the seed):

- diffuse_mis: ``render_diff`` on tests/test_grad.py's diffuse_box, MIS,
  2 spp, max_depth 3;
- ggx_nee: ``render_diff`` on its ggx_box (a GGX sphere), NEE-only, 4 spp,
  max_depth 0;
- lt_diffuse: ``render_light_diff`` on diffuse_box, 8 spp, lt_max_depth 3;
- bdpt_diffuse: ``render_bdpt_diff`` on diffuse_box, 4 spp,
  bdpt_max_path_length 4;

all at 24x20, seed 7, on the JAX package's CPU route (XLA Moller-Trumbore
intersection).

    JAX_PLATFORMS=cpu python tests/data/make_torch_grad_refs.py [name ...]

tests/test_torch_grad.py and test_torch_bdpt_grad*.py check that each stored file equals a fresh JAX
computation and holds the port's CPU gradients to it; chip_smoke.py holds
the card's gradients to the stored files.
"""
import os
import sys

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]

from torch_port_util import (GRAD_REFS, grad_case,  # noqa: E402
                             jax_grad_case)

if __name__ == "__main__":
    for name in sys.argv[1:] or list(GRAD_REFS):
        path = GRAD_REFS[name]
        arrays = jax_grad_case(name)
        np.savez(path, **arrays, case=grad_case(name))
        print(f"wrote {path}: image mean {arrays['image'].mean():.6f}, "
              f"{len(arrays)} arrays")
