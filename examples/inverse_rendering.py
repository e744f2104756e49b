"""Inverse rendering demo: recover perturbed scene parameters from an image.

What the CPU reference fundamentally cannot do: render a target, perturb the
scene (vertex positions + albedo colors + a light), and gradient-descend the
parameters back by differentiating through intersection attributes and
shading.  Saves before/target/after renders as PNG.

Usage:
    python examples/inverse_rendering.py [outdir] [--steps N] [--scene path]

Runs on whatever backend jax picks (the GPU where there is one; forced-CPU
works too).
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv):
    import jax.numpy as jnp
    import optax

    from crt_tpu import RenderSettings, load_scene, render_image
    from crt_tpu.io.ppm import quantize
    from crt_tpu.optim import fit_scene
    from crt_tpu.scene.procedural import make_test_scene
    from crt_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    outdir = argv[0] if argv and not argv[0].startswith("-") else "inverse_demo"
    steps = int(argv[argv.index("--steps") + 1]) if "--steps" in argv else 120
    os.makedirs(outdir, exist_ok=True)

    if "--scene" in argv:
        scene = load_scene(argv[argv.index("--scene") + 1])
    else:
        scene = make_test_scene(width=192, height=128, num_quads=8,
                                with_reflective=False, seed=3)
    settings = RenderSettings()

    target = render_image(scene, settings)

    rng = np.random.default_rng(0)
    perturbed = {
        "vertices": scene.vertices + jnp.asarray(
            rng.normal(scale=0.08, size=scene.vertices.shape).astype(np.float32)),
        "tex_color_a": jnp.clip(
            scene.tex_color_a + jnp.asarray(
                rng.normal(scale=0.25, size=scene.tex_color_a.shape)
                .astype(np.float32)), 0.02, 1.0),
        "light_intensity": scene.light_intensity * 0.6,
    }

    def save(name, img):
        from PIL import Image

        Image.fromarray(quantize(np.asarray(img)).astype(np.uint8)).save(
            os.path.join(outdir, name)
        )

    save("target.png", target)
    save("perturbed.png",
         render_image(scene.replace(**perturbed), settings))

    params, losses = fit_scene(
        scene, target, params=perturbed, settings=settings,
        optimizer=optax.adam(5e-3), steps=steps,
        callback=lambda i, l: (i % 20 == 0) and print(
            f"step {i}: loss {l:.6f}", flush=True),
    )
    save("recovered.png", render_image(scene.replace(**params), settings))

    print(f"loss {losses[0]:.6f} -> {losses[-1]:.6f} "
          f"({losses[0] / max(losses[-1], 1e-12):.0f}x reduction); "
          f"renders in {outdir}/")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
