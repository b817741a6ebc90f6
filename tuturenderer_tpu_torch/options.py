"""Render configuration, mirrored field for field from
``tuturenderer_tpu/options.py`` so one options object means the same render
in both packages. The fields are plain Python values.

This package implements the unidirectional MIS path tracer without
compaction; ``integrators/path.py`` raises ``NotImplementedError`` for the
fields it does not serve yet (``mis=False``, ``compaction``,
``alpha_shadows``, ``differentiable``).
"""
from __future__ import annotations

import dataclasses

EPSILON = 5e-4          # global.hpp:16
MIN_DIVISOR = 0.04      # global.hpp:26
GAMMA_VAL = 0.78        # global.hpp:30


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    spp: int = 64                 # global.hpp:19
    max_depth: int = 6            # PathTracing.hpp:5
    min_depth: int = 3            # PathTracing.hpp:6 (RR warmup)
    lt_max_depth: int = 2         # LightTracing.hpp:6 (shared MAXDEPTH)
    bdpt_max_path_length: int = 7  # BDPT.hpp:8
    mis: bool = True              # global.hpp:25
    russian_roulette: bool = True
    jitter: bool = False          # reference has no sub-pixel jitter
    gamma: float = GAMMA_VAL
    # alpha-weighted soft shadows: NEE visibility becomes the product of
    # (1-alpha) over occluders (BVHStrategy.hpp:13-45)
    alpha_shadows: bool = False
    # BDPT debug harness (BDPT.hpp:9-12): -1 disables a filter
    bdpt_s_filter: int = -1
    bdpt_t_filter: int = -1
    bdpt_unweighted: bool = False
    # compat knobs reproducing reference quirks
    tutu_light_pick: bool = False
    tutu_tri_sample: bool = False
    ggx_sample_bug: bool = False
    tutu_bdpt_weight_kill: bool = True
    tutu_bdpt_t1_gate: bool = True
    # batching: rays processed per device dispatch (0 = whole frame)
    rays_per_pass: int = 0
    # samples batched into ONE wavefront (lane = (sample, blocked pixel));
    # a scheduling choice only: the image is the same
    samples_per_launch: int = 1
    # wavefront compaction: per-bounce live-lane fraction schedule
    compaction: tuple = ()
    # detach sampling decisions for material-parameter gradients
    differentiable: bool = False
