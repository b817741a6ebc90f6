"""Write the JAX renders the light tracer, the naive path tracer and
wavefront compaction of the PyTorch port are held to
(``tests/torch_port_util.py`` INTEGRATOR_CASES and INTEGRATOR_REFS), one
``tests/data/torch_<case>_jax_ref.npz`` each, at 4 spp and seed 3:

- lt_box / naive_box: light tracing and naive PT on simple_box at 24x20,
  its dense Pallas kernels in interpret mode;
- lt_showcase / naive_showcase: the same on sphere_showcase(nu=46, nv=46),
  4,236 triangles, at 24x20 with lt_max_depth 4 (the JAX package's CPU
  route: its XLA BVH);
- compact_mis / compact_overflow: the MIS path tracer on simple_box at
  80x64 under compaction=(1.0, 0.5) (no overflow) and (1.0, 0.25)
  (the overflow roulette engages), with the overflow count;
- bdpt_box / bdpt_showcase: BDPT on simple_box at bdpt_max_path_length 3
  (its dense Pallas kernels in interpret mode) and on
  sphere_showcase(nu=46, nv=46) at 5 (the JAX package's CPU route), at
  24x20;
- bdpt_showcase_quirks_off: the showcase case with
  tutu_bdpt_weight_kill=False and tutu_bdpt_t1_gate=False;
- bdpt_showcase_7: the showcase case at the default bdpt_max_path_length
  7, the length of every BDPT path on the card (~50 s of JAX compile).

Each file also stores, under ``case``, how its render was made (JSON: the
integrator, the scene preset, the size, the RenderOptions fields and the
seed), so that chip_smoke.py renders the same case from the file alone.

    JAX_PLATFORMS=cpu python tests/data/make_torch_integrator_refs.py

tests/test_torch_light_render.py, test_torch_naive.py,
test_torch_compaction_jax.py, test_torch_compaction_roomy.py and
test_torch_bdpt_{box,showcase,quirks,showcase7}.py check that
each stored render equals a fresh JAX render, and chip_smoke.py holds the
port's GPU renders against them.
"""
import os
import sys

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]

from torch_port_util import (INTEGRATOR_REFS,  # noqa: E402
                             integrator_case, jax_integrator_render)

if __name__ == "__main__":
    names = sys.argv[1:] or list(INTEGRATOR_REFS)
    for name in names:
        out = jax_integrator_render(name)
        np.savez(INTEGRATOR_REFS[name], **out, case=integrator_case(name))
        extra = {k: int(v) for k, v in out.items() if k != "image"}
        print(f"wrote {INTEGRATOR_REFS[name]}: shape {out['image'].shape}, "
              f"mean {out['image'].mean():.6f} {extra}")
