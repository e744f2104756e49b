"""Standalone CLI — the ``crt_renderer`` equivalent (src/standalone/main.cpp).

Usage:
    python -m crt_tpu.frontend.cli [scene.crtscene] [out.ppm] [options]

Mirrors the reference CLI contract: two positional args with the same
defaults, wall-clock timing of the render (excluding scene load / tree
build) printed as "Execution time: N seconds." (main.cpp:37-43).
"""

from __future__ import annotations

import argparse
import sys
import time

import jax
import numpy as np

from crt_tpu.io.ppm import write_ppm
from crt_tpu.renderer import render_image_hwc
from crt_tpu.scene.json_loader import SceneFormatError, load_scene
from crt_tpu.scene.types import RenderSettings


def main(argv=None):
    from crt_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    p = argparse.ArgumentParser(
        prog="crt-render", description="CRT ray tracer (JAX)"
    )
    p.add_argument(
        "scene",
        nargs="?",
        default="/root/reference/scenes/15-01-conclusion/scene2.crtscene",
        help="input .crtscene (default mirrors the reference CLI)",
    )
    p.add_argument("output", nargs="?", default="output.ppm")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "bruteforce", "tree", "pallas"])
    p.add_argument("--aov", default="",
                   choices=["", "bary", "normal", "depth", "tri_id",
                            "albedo"],
                   help="render an auxiliary pass instead of beauty")
    p.add_argument("--max-ray-depth", type=int, default=None)
    p.add_argument("--gi-rays", type=int, default=None)
    p.add_argument("--head-compat", action="store_true",
                   help="replicate reference-HEAD quirks (no shadows, "
                        "unconditional GI divide)")
    p.add_argument("--width", type=int, default=None, help="override width")
    p.add_argument("--height", type=int, default=None, help="override height")
    p.add_argument("--repeat", type=int, default=1,
                   help="re-render N times and report the best time")
    args = p.parse_args(argv)

    try:
        scene = load_scene(args.scene)
    except (OSError, SceneFormatError, ValueError) as e:
        print(f"Error: Could not parse scene file: {args.scene}: {e}",
              file=sys.stderr)
        return 1

    if args.width or args.height:
        scene = scene.replace(
            width=args.width or scene.width,
            height=args.height or scene.height,
        )

    settings = RenderSettings(backend=args.backend,
                              head_compat=args.head_compat,
                              aov=args.aov)
    if args.max_ray_depth is not None:
        settings = settings.replace(max_ray_depth=args.max_ray_depth)
    if args.gi_rays is not None:
        settings = settings.replace(diffuse_reflection_ray_count=args.gi_rays)

    best = float("inf")
    image = None
    for _ in range(max(1, args.repeat)):
        start = time.perf_counter()
        image = jax.block_until_ready(render_image_hwc(scene, settings))
        best = min(best, time.perf_counter() - start)

    print(f"Execution time: {best} seconds.")

    write_ppm(np.asarray(image), args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
