"""Render every course scene and write PPM + PNG artifacts + a results table.

The tools/submit_render_task.sh equivalent (reference renders every scene of
a task, converts PPM->PNG with ImageMagick, and regenerates README tables).

Usage: python tools/render_all.py [outdir] [filter...]
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv):
    from crt_tpu import RenderSettings, load_scene, render_image
    from crt_tpu.io.ppm import quantize, write_ppm
    from crt_tpu.utils import golden
    from crt_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    outdir = argv[0] if argv and not argv[0].startswith("-") else "results"
    filters = argv[1:] if argv else []
    os.makedirs(os.path.join(outdir, "ppm"), exist_ok=True)
    os.makedirs(os.path.join(outdir, "png"), exist_ok=True)

    cases = golden.LEGACY_GOLDEN_CASES + golden.HEAD_GOLDEN_CASES
    if filters:
        cases = [c for c in cases if any(f in c[0] for f in filters)]

    rows = []
    for rel, name, overrides in cases:
        t0 = time.time()
        try:
            scene = load_scene(str(golden.SCENES / rel))
            # aov is a first-class RenderSettings field — profiles apply
            # verbatim through render_image.
            img = np.asarray(render_image(scene, RenderSettings(**overrides)))
            dt = time.time() - t0
            write_ppm(img, os.path.join(outdir, "ppm", f"{name}.ppm"))
            from PIL import Image

            Image.fromarray(quantize(img).astype(np.uint8)).save(
                os.path.join(outdir, "png", f"{name}.png")
            )
            frac, mae = golden.match_stats(img, golden.load_golden(name))
            rows.append((name, f"{dt:.2f}s", f"{frac:.4f}", f"{mae:.5f}"))
            print(f"{name}: t={dt:.2f}s frac={frac:.4f}", flush=True)
        except Exception as e:  # noqa
            rows.append((name, "ERROR", type(e).__name__, str(e)[:60]))
            print(f"{name}: ERROR {e}", flush=True)

    with open(os.path.join(outdir, "README.md"), "w") as f:
        f.write("# crt_tpu renders of the course scenes\n\n")
        f.write("| Scene | Render time | Golden match | MAE |\n|---|---|---|---|\n")
        for r in rows:
            f.write("| " + " | ".join(r) + " |\n")
    print(f"wrote {outdir}/README.md")


if __name__ == "__main__":
    main(sys.argv[1:])
