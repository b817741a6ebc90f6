"""tuturenderer_tpu_torch: the path tracer in PyTorch, with CUDA kernels.

A port of ``tuturenderer_tpu`` (JAX/Pallas) that keeps its module layout
and names. Plain tensor code is PyTorch; the ray/triangle kernels (dense
and cluster) and the visit-walk probe are CUDA C++ for Hopper (``csrc/``),
built with nvcc at first use. On CPU tensors every kernel wrapper runs its
plain PyTorch version instead.

This package imports neither ``jax`` nor ``tuturenderer_tpu``.
"""
from .camera import Camera, make_camera
from .options import RenderOptions
from .scene.data import SceneBuilder, SceneData

__all__ = ["Camera", "make_camera", "RenderOptions", "SceneBuilder",
           "SceneData"]
__version__ = "0.1.0"
