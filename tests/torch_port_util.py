"""Shared helpers for the tests that hold the PyTorch port
(``tuturenderer_tpu_torch``) against the JAX package.

- ``flatten`` turns a SceneData or Camera of either package into a dict of
  numpy arrays keyed by field name (dotted for nested fields), the form
  ``scene_from_numpy`` / ``camera_from_numpy`` take;
- ``jax_dense_pallas_interpret`` makes the JAX package take its dense
  Pallas kernels (the Woop kernels the port's CUDA kernels replace) in
  interpret mode on the CPU, within the block only;
- ``REF_*`` say how ``tests/data/torch_simple_box_jax_ref.npy`` is made.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os

import numpy as np

REF_PATH = os.path.join(os.path.dirname(__file__), "data",
                        "torch_simple_box_jax_ref.npy")
REF_SIZE = (24, 20)     # not a power of two: no pixel centre on a knife edge
REF_SPP = 4
REF_SEED = 3


def flatten(obj, key: str = "") -> dict:
    """Dataclass/Vec3 tree -> {dotted field name: numpy array}; None
    fields (no BVH/clusters) are left out."""
    if obj is None:
        return {}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):      # Vec3
        return {f"{key}.{c}": np.asarray(getattr(obj, c)) for c in obj._fields}
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            out.update(flatten(getattr(obj, f.name),
                               f"{key}.{f.name}" if key else f.name))
        return out
    return {key: np.asarray(obj)}


@contextlib.contextmanager
def jax_dense_pallas_interpret():
    """Route the JAX package's dense intersection through its Pallas Woop
    kernels in interpret mode, and clear JAX's caches on entry and exit so
    no traced function crosses the boundary."""
    import jax

    import tuturenderer_tpu.ops.intersect as JI
    import tuturenderer_tpu.ops.pallas.intersect as JP
    saved = (JI.DENSE_IMPL, JP.pallas_tri_intersect, JP.pallas_tri_occluded)
    jax.clear_caches()
    JI.DENSE_IMPL = "pallas"
    JP.pallas_tri_intersect = functools.partial(saved[1], interpret=True)
    JP.pallas_tri_occluded = functools.partial(saved[2], interpret=True)
    try:
        yield
    finally:
        JI.DENSE_IMPL, JP.pallas_tri_intersect, JP.pallas_tri_occluded = saved
        jax.clear_caches()


def jax_reference_render() -> np.ndarray:
    """The JAX render the stored reference image holds."""
    from tuturenderer_tpu.integrators.path import render
    from tuturenderer_tpu.options import RenderOptions
    from tuturenderer_tpu.scene.presets import simple_box
    scene, cam = simple_box(*REF_SIZE)
    with jax_dense_pallas_interpret():
        return np.asarray(render(scene, cam, RenderOptions(spp=REF_SPP),
                                 seed=REF_SEED))
