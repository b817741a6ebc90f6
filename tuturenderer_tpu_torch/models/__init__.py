"""Scene models: procedural mesh generators and mesh-scale presets."""
from .meshes import heightfield, plane, quad, uv_sphere  # noqa: F401
from .scenes import sphere_showcase, terrain  # noqa: F401
