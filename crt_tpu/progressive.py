"""Progressive multi-pass GI accumulation with checkpoint/resume.

The reference renders GI in a single pass of K hemisphere samples per
diffuse bounce (crt_renderer.cpp:60-79, settings.diffuse_reflection_ray_count
— e.g. the 15-01 showcase scenes).  Noise falls as 1/sqrt(samples), so
production-quality frames want far more samples than fit one compiled
program (K multiplies every per-bounce buffer).  This module accumulates
*passes* instead: each pass renders the full frame with the SAME compiled
program but a per-pass fork of every pixel's PCG32 stream
(``rng.salt_stream`` — different ``inc`` selectors give independent PCG
sequences), and the running mean converges to the many-sample image.

Pass 0 uses the unsalted streams, so a 1-pass progressive render is
bit-exact the single-shot ``render_image``.

Checkpoint/resume: the running sum and pass counter are orbax-checkpointed
every ``checkpoint_every`` passes — an interrupted accumulation (preemption
being the normal failure mode of long accelerator jobs) resumes at the last saved
pass with identical output, because pass k's image depends only on k.  The
same mechanism serves as the long-render failure-recovery story alongside
crt_tpu.parallel.multihost's row-block re-dispatch.

No reference equivalent (single-process, one-shot: crt_renderer.cpp:147-215);
SURVEY.md §5 checkpoint/resume.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from crt_tpu.renderer import _render_flat
from crt_tpu.scene.types import RenderSettings, Scene


def render_progressive(
    scene: Scene,
    settings: RenderSettings | None = None,
    passes: int = 8,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    callback: Optional[Callable[[int, jnp.ndarray], None]] = None,
) -> jnp.ndarray:
    """Accumulate ``passes`` decorrelated GI renders -> [h, w, 3] mean image.

    One program compile total: the pass index enters as a traced uint32
    salt.  ``callback(pass_idx, running_mean)`` fires after each pass (e.g.
    for preview writes).  With ``checkpoint_dir``, the accumulation state
    is saved every ``checkpoint_every`` passes (default: only at the end)
    and a matching directory resumes where it left off.
    """
    settings = settings or RenderSettings()
    fn = jax.jit(lambda s, salt: _render_flat(s, settings, gi_salt=salt))

    h, w = scene.height, scene.width
    accum = jnp.zeros((h, w, 3), jnp.float32)
    start = 0

    mngr = _checkpoint_manager(checkpoint_dir) if checkpoint_dir else None
    if mngr is not None and mngr.latest_step() is not None:
        restored = mngr.restore(mngr.latest_step())
        accum = jnp.asarray(restored["accum"])
        start = int(restored["passes_done"])

    for p in range(start, passes):
        img = fn(scene, jnp.uint32(p))
        accum = accum + img
        done = p + 1
        if callback is not None:
            callback(p, accum / done)
        if mngr is not None and (
            done == passes
            or (checkpoint_every and done % checkpoint_every == 0)
        ):
            mngr.save(done, args=_save_args(accum, done))
    if mngr is not None:
        mngr.wait_until_finished()
    return accum / max(passes, 1)


def _checkpoint_manager(directory: str):
    import orbax.checkpoint as ocp

    return ocp.CheckpointManager(
        directory, options=ocp.CheckpointManagerOptions(max_to_keep=2)
    )


def _save_args(accum, passes_done):
    import orbax.checkpoint as ocp

    return ocp.args.StandardSave(
        {"accum": accum, "passes_done": passes_done}
    )
