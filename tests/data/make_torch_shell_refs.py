"""Write what the JAX package's shell computed, for the PyTorch port's
shell tests (``tests/torch_port_util.py`` SHELL_CASES and SHELL_REFS), one
``tests/data/torch_shell_<case>_jax_ref.npz`` each:

- cli_ppm: the JAX CLI's PPM of tests/test_cli.py's CONFIG at
  ``--spp 2 --max-depth 2`` (8-bit values);
- checkpoint_path / checkpoint_light: the checkpoint (film, spp_done,
  seed, direct, dmask) JAX's render_progressive wrote after 2 of the 4
  samples of the stored simple_box path render
  (``torch_simple_box_jax_ref.npy``) and of the stored light-tracing
  render (``torch_lt_box_jax_ref.npz``), at 24x20, seed 3, in 2-spp
  chunks;
- grid: JAX's estimator_grid of CONFIG at spp 2, max_depth 2, seed 0.

simple_box and CONFIG go through the JAX package's dense Pallas kernels in
interpret mode. Each file also stores, under ``case``, how it was made
(JSON).

    JAX_PLATFORMS=cpu python tests/data/make_torch_shell_refs.py [name ...]

tests/test_torch_cli.py and test_torch_progressive.py hold the port to
them.
"""
import os
import sys
import tempfile

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]

from torch_port_util import SHELL_REFS, jax_shell_ref, shell_case  # noqa: E402

if __name__ == "__main__":
    for name in sys.argv[1:] or list(SHELL_REFS):
        out = jax_shell_ref(name, tempfile.mkdtemp())
        np.savez(SHELL_REFS[name], **out, case=shell_case(name))
        print(f"wrote {SHELL_REFS[name]}: "
              f"{ {k: v.shape for k, v in out.items()} }")
