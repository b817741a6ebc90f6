"""Command-line entry point.

Usage: ``python -m tuturenderer_tpu_torch <config.txt> [options]``, the
port of ``tuturenderer_tpu/cli.py``: the equivalent of the reference's
``./PathTracing.exe config.txt`` (README.md:59-62), with the compile-time
#define knobs exposed as flags. Output defaults to ``<config>.ppm`` next to
the input like PPMGenerator::generate (PPMGenerator.hpp:140-160), or a PNG
by the output's suffix.

The flags are the JAX package's, with one more: ``--device`` (default
``cuda``), where the scene, the camera and every render live. Without a
card, ``--device cuda`` raises; pass ``--device cpu`` to render on the
CPU.

The JAX package traces a frame's samples in one compiled loop; the port
dispatches every wavefront from the host, and one costs about as much host
time at 16k lanes as at 1M. So the CLI batches samples into wavefronts of
up to ``WAVEFRONT_LANES`` lanes (``RenderOptions.samples_per_launch``;
the image is that of one sample a wavefront, up to float order).
"""
from __future__ import annotations

import argparse
import contextlib

# the largest wavefront the port's paths run: BDPT holds ~16 KB a lane
# at its peak, 16 GB at 2^20 lanes on an H100
WAVEFRONT_LANES = 1 << 20


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="tuturenderer_tpu_torch",
        description="PyTorch/CUDA differentiable path tracer")
    ap.add_argument("config", help="scene config file (reference grammar)")
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--max-depth", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--integrator", default=None,
                    help="override config integrator (path/light/naivept/bdpt)")
    ap.add_argument("--no-mis", action="store_true")
    ap.add_argument("--jitter", action="store_true",
                    help="enable sub-pixel jitter (reference has none)")
    ap.add_argument("--gamma", type=float, default=0.78)
    ap.add_argument("--estimator-grid", action="store_true",
                    help="render the 2x2 estimator comparison grid "
                         "(BSDF-only | light-only // NEE | NEE+MIS), the "
                         "reference README's A/B figure")
    ap.add_argument("--alpha-shadows", action="store_true",
                    help="alpha-weighted soft shadows: NEE visibility = "
                         "prod(1-alpha) over occluders (getShadowCoeffi)")
    ap.add_argument("--post", action="store_true",
                    help="bloom + exposure tone-mapping post pass")
    ap.add_argument("--bdpt-s", type=int, default=-1,
                    help="debug: isolate BDPT strategies with this light-"
                         "subpath length s (reference S_CHECK)")
    ap.add_argument("--bdpt-t", type=int, default=-1,
                    help="debug: isolate BDPT strategies with this eye-"
                         "subpath length t (reference T_CHECK)")
    ap.add_argument("--bdpt-unweighted", action="store_true",
                    help="debug: drop MIS weights to validate a strategy's "
                         "unweighted contribution (reference CHECK_MIS)")
    ap.add_argument("--raster-check", action="store_true",
                    help="debug: render the raster-projection consistency "
                         "pass instead of the integrator (reference "
                         "CHECK_LT, LightTracing.hpp:28-93)")
    ap.add_argument("-o", "--output", default=None,
                    help="output path (.ppm or .png); default <config>.ppm")
    ap.add_argument("--profile", action="store_true",
                    help="print per-phase timings and throughput counters")
    ap.add_argument("--trace-dir", default=None,
                    help="write a torch.profiler trace (Chrome trace "
                         "format) into this directory")
    ap.add_argument("--checkpoint", default=None,
                    help="film checkpoint path: render progressively and "
                         "resume from it after interruption")
    ap.add_argument("--chunk-spp", type=int, default=8,
                    help="spp per progressive chunk (with --checkpoint)")
    ap.add_argument("--invert", default=None, metavar="TARGET",
                    help="inverse rendering: recover the material table "
                         "(albedo/emission/roughness/metallic) by gradient "
                         "descent against TARGET (.ppm/.png, de-gammaed), "
                         "then render with the recovered materials. The "
                         "capability the reference's forward-only design "
                         "cannot offer; uses grad.image_loss_and_grad")
    ap.add_argument("--invert-steps", type=int, default=60)
    ap.add_argument("--invert-lr", type=float, default=0.2)
    ap.add_argument("--device", default="cuda",
                    help="device of the scene and the renders (cuda, cpu)")
    args = ap.parse_args(argv)

    from .io.ppm import write_png, write_ppm
    from .options import RenderOptions
    from .render import render_image, render_progressive
    from .scene.config import parse_config
    from .utils.profiling import Profiler, trace

    prof = Profiler(enabled=args.profile)
    with prof.phase("scene build"):
        pc = parse_config(args.config)
        scene = pc.builder.build(device=args.device)
        cam = pc.camera(device=args.device)
    integrator = args.integrator or pc.integrator
    opts = RenderOptions(spp=args.spp, max_depth=args.max_depth,
                         mis=not args.no_mis, jitter=args.jitter,
                         gamma=args.gamma, alpha_shadows=args.alpha_shadows,
                         bdpt_s_filter=args.bdpt_s, bdpt_t_filter=args.bdpt_t,
                         bdpt_unweighted=args.bdpt_unweighted,
                         samples_per_launch=samples_per_launch(
                             args.spp, cam.n_pixels))

    if args.invert:
        scene = _invert_materials(scene, cam, opts, args)

    ctx = trace(args.trace_dir) if args.trace_dir else contextlib.nullcontext()
    with ctx, prof.phase("render"):
        if args.raster_check:
            from .integrators.light import raster_check
            img = raster_check(scene, cam, opts, seed=args.seed).cpu().numpy()
        elif args.estimator_grid:
            from .render import estimator_grid
            img = estimator_grid(scene, cam, opts, seed=args.seed)
        elif args.checkpoint:
            img = render_progressive(scene, cam, opts, integrator=integrator,
                                     seed=args.seed,
                                     chunk_spp=args.chunk_spp,
                                     checkpoint_path=args.checkpoint)
            if args.post:
                import torch

                from .post import bloom_and_tonemap
                img = bloom_and_tonemap(torch.from_numpy(img).to(
                    scene.device)).cpu().numpy()
        else:
            img = render_image(scene, cam, opts, integrator=integrator,
                               seed=args.seed, postprocess=args.post)
    if args.profile:
        totals = prof.report()
        render_s = totals.get("render", 0.0)
        if render_s > 0:
            paths = cam.n_pixels * opts.spp
            print(f"  {paths / 1e6:.2f}M paths, "
                  f"{paths / render_s / 1e6:.2f} M paths/s", flush=True)

    out = args.output
    if out is None:
        base = args.config[:-4] if args.config.endswith(".txt") else args.config
        out = base + ".ppm"
    if out.endswith(".png"):
        write_png(out, img, args.gamma)
    else:
        write_ppm(out, img, args.gamma)
    print(f"Generating image successfully: {out}")


def samples_per_launch(spp: int, n_pixels: int) -> int:
    """Samples a wavefront carries: as many as fit in WAVEFRONT_LANES."""
    return max(1, min(spp, WAVEFRONT_LANES // max(n_pixels, 1)))


def _invert_materials(scene, cam, opts, args):
    """Inverse-rendering loop: ``grad.invert_materials`` (SGD on the
    material table against a target image through the differentiable path
    tracer, each parameter projected into its valid range after a step).
    The target is de-gammaed back to linear radiance (write_ppm/write_png
    store clip(img)^gamma). Prints the L2 loss of every 10th step and of
    the last, and returns the scene with the recovered materials."""
    import numpy as np
    import torch

    from .grad import get_params, invert_materials, put_params
    from .io.ppm import read_png, read_ppm

    reader = read_png if args.invert.endswith(".png") else read_ppm
    target = np.asarray(reader(args.invert), np.float32)
    if target.shape[:2] != (cam.height, cam.width):
        raise SystemExit(
            f"--invert target is {target.shape[1]}x{target.shape[0]}, "
            f"config renders {cam.width}x{cam.height}")
    target = torch.from_numpy(target ** (1.0 / args.gamma)).to(scene.device)
    params, losses = invert_materials(get_params(scene), target, scene, cam,
                                      opts, args.invert_steps,
                                      args.invert_lr, seed=args.seed)
    for step, loss in enumerate(losses):
        if step % 10 == 0 or step == args.invert_steps - 1:
            print(f"invert step {step:4d}: loss {loss:.6f}", flush=True)
    d = [c.cpu().numpy() for c in params.diffuse]
    for i in range(d[0].shape[0]):
        print(f"invert material[{i}] diffuse = "
              f"{d[0][i]:.4f} {d[1][i]:.4f} {d[2][i]:.4f}", flush=True)
    return put_params(scene, params)


if __name__ == "__main__":
    main()
