"""Scene models: procedural mesh generators and mesh-scale presets.

The reference-mirroring scenes (Cornell box, Veach BDPT room, the simple
box) live in ``scene/presets.py``; re-exported here as the JAX package
does.
"""
from ..scene.presets import cornell_box, simple_box, veach_bdpt  # noqa: F401
from .meshes import heightfield, plane, quad, uv_sphere  # noqa: F401
from .scenes import sphere_showcase, terrain  # noqa: F401
