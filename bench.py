"""Headline benchmark: the course-benchmark-shaped frame on one GPU.

Workload (S1): the seeded stand-in for the reference's acceleration-tree
scene (crt_tpu.scene.procedural.make_course_benchmark_scene) — 4,014
triangles, 4 point lights, one diffuse material, 1920x1080, shadows on.
The reference's optimization report times that shape at 0.066962 s with
the KD tree on a Ryzen 7 8845HS ≈ 31.0 M primary rays/s (BASELINE.md); the
mesh differs, so the ratio is indicative only.

Metrics: primary-ray throughput (Mrays/s) of (a) the full forward render
(1 primary + 4 shadow traces per pixel) and (b) forward+backward —
``value_and_grad`` of the image sum w.r.t. vertices, light intensities and
camera position.  Each is the median over repeated runs of one jitted step,
timed on the host clock around ``block_until_ready`` after a warm-up.

Fails without a GPU.  Prints ONE json line naming the device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BASELINE_MRAYS = 31.0  # 1920*1080 / 0.066962 s (BASELINE.md)
RUNS = 20


def main():
    import numpy as np

    import jax
    import jax.numpy as jnp

    device = jax.devices()[0]
    if device.platform != "gpu":
        sys.exit(f"bench.py: no GPU (JAX platform {device.platform!r})")
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    from crt_tpu import RenderSettings
    from crt_tpu.renderer import _render_flat
    from crt_tpu.scene.procedural import make_course_benchmark_scene
    from crt_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    scene = make_course_benchmark_scene()
    settings = RenderSettings()

    fwd = jax.jit(lambda s: _render_flat(s, settings))

    def loss(vertices, lights, cam):
        s = scene.replace(vertices=vertices, light_intensity=lights,
                          cam_position=cam)
        return jnp.sum(_render_flat(s, settings))

    fwdbwd = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2)))

    def median_ms(fn) -> float:
        jax.block_until_ready(fn())
        times = []
        for _ in range(RUNS):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            times.append(time.perf_counter() - t0)
        return float(np.median(times)) * 1e3

    ms_fwd = median_ms(lambda: fwd(scene))
    ms_grad = median_ms(lambda: fwdbwd(
        scene.vertices, scene.light_intensity, scene.cam_position
    ))

    px = scene.width * scene.height
    mrays = px / ms_fwd / 1e3
    mrays_grad = px / ms_grad / 1e3
    print(json.dumps({
        "metric": "primary Mrays/s fwd, S1 course-benchmark shape",
        "value": round(mrays, 3),
        "unit": "Mrays/s",
        "vs_baseline": round(mrays / BASELINE_MRAYS, 3),
        "fwd_ms": round(ms_fwd, 4),
        "fwd_bwd_ms": round(ms_grad, 4),
        "fwd_bwd_mrays": round(mrays_grad, 3),
        "fwd_bwd_vs_baseline": round(mrays_grad / BASELINE_MRAYS, 3),
        "platform": device.platform,
        "device_kind": device.device_kind,
        "device_count": len(jax.devices()),
        "card": power,
    }))


if __name__ == "__main__":
    main()
