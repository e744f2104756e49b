"""Render every golden-covered scene and report pixel-match stats.

Runs on whatever backend jax picks (the GPU where there is one).  Usage:

    python tools/golden_check.py [case-substring ...] [--json out.json]
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from crt_tpu import RenderSettings, load_scene, render_image
from crt_tpu.utils import golden


def main(argv):
    from crt_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    argv = list(argv)
    skip = set()
    if "--json" in argv:
        skip.add(argv.index("--json") + 1)
    filters = [
        a for i, a in enumerate(argv)
        if not a.startswith("-") and i not in skip
    ]
    cases = golden.LEGACY_GOLDEN_CASES + golden.HEAD_GOLDEN_CASES
    if filters:
        cases = [c for c in cases if any(f in c[0] for f in filters)]

    results = []
    for rel, name, overrides in cases:
        path = golden.SCENES / rel
        t0 = time.time()
        try:
            scene = load_scene(str(path))
            # aov is a first-class RenderSettings field: profiles apply
            # verbatim (render_image routes AOV passes itself).
            img = np.asarray(render_image(scene, RenderSettings(**overrides)))
            frac, mae = golden.match_stats(img, golden.load_golden(name))
            dt = time.time() - t0
            print(f"{name}: frac={frac:.4f} mae={mae:.5f} t={dt:.1f}s", flush=True)
            results.append((name, frac, mae))
        except Exception as e:  # noqa
            print(f"{name}: ERROR {type(e).__name__}: {e}", flush=True)
            results.append((name, 0.0, 1.0))

    worst = min(results, key=lambda r: r[1]) if results else None
    print(f"\n{len(results)} cases, worst: {worst}")

    if "--json" in argv:
        import json

        out = argv[argv.index("--json") + 1]
        with open(out, "w") as f:
            json.dump(
                [
                    {"name": n, "frac": round(fr, 5), "mae": round(m, 6)}
                    for n, fr, m in results
                ],
                f,
                indent=1,
            )
        print(f"wrote {out}")


if __name__ == "__main__":
    main(sys.argv[1:])
