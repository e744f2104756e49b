"""Multi-host runtime: distributed init, render dispatch, gather, recovery.

The reference is a single process whose only "communication layer" is one
mutex-guarded bucket queue (crt_renderer.cpp:176-191).  The JAX
equivalent for device meshes spanning hosts:

  - ``initialize()`` wraps ``jax.distributed.initialize`` (coordinator
    address/process id/count from env or args) so every host joins one JAX
    runtime; collectives ride ICI within a slice and DCN across slices.
  - ``render_image_multihost()`` renders with rows sharded across the global
    device set (same code path as parallel.sharded — shard_map is
    multi-host-transparent) and returns the full framebuffer on every host
    via ``process_allgather``.
  - Fault story (SURVEY.md §5): renders are stateless — "recovery" is
    re-dispatching the same pure function after ``jax.distributed`` re-init;
    ``render_rows_local()`` exposes the per-host row block so an external
    scheduler can re-render lost blocks (tiles of a failed host) anywhere.

Single-host processes (this CI) run through the same functions unchanged —
``initialize()`` is a no-op when no coordinator is configured.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np

from crt_tpu.parallel.sharded import make_mesh, render_image_sharded
from crt_tpu.scene.types import RenderSettings, Scene


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join the multi-host JAX runtime.  Returns True if distributed mode is
    active.  Arguments default to JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES
    / JAX_PROCESS_ID env vars; with none set this is a no-op (single host).
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if coordinator_address is None:
        return False
    kwargs = {"coordinator_address": coordinator_address}
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)
    return True


def global_mesh(axis_name: str = "rays"):
    """Mesh over every device of every process."""
    return make_mesh(jax.devices(), axis_name)


def render_image_multihost(
    scene: Scene,
    settings: RenderSettings | None = None,
    mesh=None,
) -> np.ndarray:
    """Render with rows sharded over the global device set; every host
    returns the assembled [H, W, 3] framebuffer."""
    from jax.experimental import multihost_utils

    mesh = mesh or global_mesh()
    img = render_image_sharded(scene, settings, mesh)
    if jax.process_count() == 1:
        return np.asarray(img)
    # Each process holds its addressable shards; gather the full buffer.
    return np.asarray(multihost_utils.process_allgather(img, tiled=True))


def render_rows_local(
    scene: Scene,
    row_start: int,
    num_rows: int,
    settings: RenderSettings | None = None,
):
    """Render an arbitrary row block on the local process — the unit of
    work an external scheduler re-dispatches when a host is lost."""
    import jax.numpy as jnp

    from crt_tpu.parallel.sharded import _render_rows

    settings = settings or RenderSettings()
    fn = jax.jit(
        lambda s, start: _render_rows(s, settings, start, num_rows)
    )
    return fn(scene, jnp.int32(row_start))


class BlockRenderError(RuntimeError):
    """A row block failed after exhausting its retries."""


def render_blocks_with_recovery(
    scene: Scene,
    settings: RenderSettings | None = None,
    num_blocks: int = 4,
    render_block=None,
    max_attempts: int = 3,
) -> np.ndarray:
    """Block scheduler with failure detection and re-dispatch.

    The recovery story (SURVEY.md §5): renders are stateless, so losing a
    worker loses only its row block — re-render it anywhere.  This is the
    dispatcher for that: the frame is cut into ``num_blocks`` row blocks,
    each rendered by ``render_block(scene, row_start, num_rows, settings)``
    (default: the local ``render_rows_local`` unit); a block that raises is
    retried up to ``max_attempts`` times and the frame is assembled from
    whichever attempts succeeded.  ``render_block`` is injectable both for
    routing blocks to other hosts and for fault-injection tests.

    Raises BlockRenderError when a block exhausts its attempts — a lost
    block must never be silently filled with zeros.
    """
    settings = settings or RenderSettings()
    if render_block is None:
        def render_block(s, start, n, st):
            return render_rows_local(s, start, n, st)

    h, w = scene.height, scene.width
    rows_per = -(-h // num_blocks)
    queue = [(b, 0) for b in range(num_blocks)]
    results: dict[int, np.ndarray] = {}
    while queue:
        b, attempt = queue.pop(0)
        start = b * rows_per
        n = min(rows_per, h - start)
        if n <= 0:
            continue
        try:
            results[b] = np.asarray(render_block(scene, start, n, settings))
        except Exception as e:  # noqa: BLE001 — any worker failure re-queues
            if attempt + 1 >= max_attempts:
                raise BlockRenderError(
                    f"row block {b} (rows {start}..{start + n}) failed "
                    f"{max_attempts} times: {e}"
                ) from e
            queue.append((b, attempt + 1))

    frame = np.zeros((h, w, 3), np.float32)
    for b, block in results.items():
        start = b * rows_per
        frame[start : start + block.shape[0]] = block[: h - start]
    return frame
