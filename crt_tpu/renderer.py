"""Top-level rendering entry points.

``render_image(scene, settings)`` is the whole public rendering API, mirroring
``crt::render_image`` (crt_renderer.h:27).  The reference's bucket queue +
thread pool (crt_renderer.cpp:157-199) is replaced by one fused XLA program
over the full pixel wavefront; multi-chip scale-out lives in
``crt_tpu.parallel`` (rays sharded over a device mesh instead of buckets over
threads).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from crt_tpu.ops import camera as camera_ops
from crt_tpu.ops import intersect as intersect_ops
from crt_tpu.ops.shade import shade_wavefront
from crt_tpu.ops.shade_iter import shade_wavefront_iter
from crt_tpu.scene.types import RenderSettings, Scene


def use_iterative_wavefront(scene: Scene, settings: RenderSettings) -> bool:
    """Shading-strategy policy.

    The iterative bank wavefront (crt_tpu.ops.shade_iter) bounds compile
    size to O(depth) on *branching* Whitted trees; the unrolled recursion
    stays optimal for linear ones (diffuse/constant: one level; pure
    mirrors: a depth-long chain).
    """
    if settings.wavefront == "iter":
        return True
    if settings.wavefront == "recursive":
        return False
    branching = scene.has_refractive and scene.refractions_on \
        and settings.max_ray_depth >= 2
    return branching or scene.gi_on


def resolve_backend(backend: str) -> str:
    """The intersection backend ``backend="auto"`` stands for here.

    On the GPU: the Pallas cluster-walk kernel, the measured winner over
    the plain XLA backends (PERF.md).  On the CPU: ``bruteforce``, the
    plain reference the tests run.  Any other platform has no supported
    default and must name a backend.
    """
    if backend != "auto":
        return backend
    platform = jax.default_backend()
    if platform == "gpu":
        return "pallas"
    if platform == "cpu":
        return "bruteforce"
    raise RuntimeError(
        f"backend='auto' has no default intersection backend on platform "
        f"{platform!r}; pass backend='bruteforce', 'tree' or 'pallas'"
    )


def make_trace_fn(scene: Scene, settings: RenderSettings):
    """Build the intersection backend ``trace_fn(origins, dirs) -> Hit``.

    The triangle-constant table is built from stop-gradiented scene arrays —
    hit *indices* are discrete; the differentiable path recomputes attributes
    in crt_tpu.ops.shade.hit_attributes.
    """
    if scene.num_triangles == 0:
        def empty_trace(origins, dirs, active=None):
            shape = origins.shape[:-1]
            return intersect_ops.Hit(
                t=jnp.full(shape, jnp.inf, jnp.float32),
                tri=jnp.full(shape, -1, jnp.int32),
            )

        return empty_trace

    backend = resolve_backend(settings.backend)
    if backend == "bruteforce":
        tri = intersect_ops.build_triangle_data(
            jax.lax.stop_gradient(scene.vertices),
            scene.tri_vidx,
            scene.mat_backface[scene.tri_material],
        )

        def trace(origins, dirs, active=None):
            del active  # dense all-pairs compute; masking cannot skip work
            return intersect_ops.closest_hit_bruteforce(tri, origins, dirs)

        return trace
    if backend == "tree":
        from crt_tpu.ops.traverse import make_tree_trace_fn

        return make_tree_trace_fn(scene)
    if backend == "pallas":
        from crt_tpu.ops.pallas_trace import make_pallas_trace_fn

        return make_pallas_trace_fn(scene)
    raise ValueError(f"unknown intersection backend: {backend!r}")


# Wavefront pixel-tile shape: rays are ordered in TILE_H x TILE_W pixel
# blocks (not scanlines) so that each consecutive run of TILE_H*TILE_W rays
# is spatially coherent — the Pallas trace bins per such run and coherent
# tiles give tight frustums.  TILE_H * TILE_W must equal
# pallas_trace.TILE_RAYS.
TILE_H = 16
TILE_W = 16


def make_tiler(h: int, w: int, row_offset=0):
    """Pixel-tile reordering helpers for an h x w region.

    Returns (raster_x [R], raster_y [R], untile(colors [R,3]) -> [h,w,3])
    with rays ordered in TILE_H x TILE_W blocks; ``row_offset`` (traced OK)
    shifts raster_y for sharded row blocks.
    """
    hp = -(-h // TILE_H) * TILE_H
    wp = -(-w // TILE_W) * TILE_W
    raster_y, raster_x = jnp.meshgrid(
        jnp.arange(hp, dtype=jnp.float32) + row_offset,
        jnp.arange(wp, dtype=jnp.float32),
        indexing="ij",
    )

    def tile(x):
        trailing = x.shape[2:]
        x = x.reshape(hp // TILE_H, TILE_H, wp // TILE_W, TILE_W, *trailing)
        x = jnp.moveaxis(x, 1, 2)
        return x.reshape(hp * wp, *trailing)

    def untile(x):
        trailing = x.shape[1:]
        x = x.reshape(hp // TILE_H, wp // TILE_W, TILE_H, TILE_W, *trailing)
        x = jnp.moveaxis(x, 2, 1)
        return x.reshape(hp, wp, *trailing)[:h, :w]

    return tile(raster_x), tile(raster_y), untile


def _render_flat(scene: Scene, settings: RenderSettings,
                 gi_salt=None) -> jnp.ndarray:
    h, w = scene.height, scene.width
    rxf, ryf, untile = make_tiler(h, w)

    origins, dirs = camera_ops.generate_rays(
        scene.cam_position,
        scene.cam_rotation,
        scene.cam_tan_half_fov,
        w,
        h,
        rxf,
        ryf,
    )
    rx = rxf.astype(jnp.uint32)
    ry = ryf.astype(jnp.uint32)

    trace_fn = make_trace_fn(scene, settings)
    use_iter = use_iterative_wavefront(scene, settings)
    shade_fn = shade_wavefront_iter if use_iter else shade_wavefront

    R = rx.shape[0]
    tile_sz = TILE_H * TILE_W
    chunk = settings.chunk_pixels
    if use_iter and not chunk:
        # The bank pool multiplies every per-bounce buffer by B.  The
        # dominant memory term is the per-bounce shadow work: L lights x B
        # x R lanes, and for refractive scenes the transmissive marching
        # runs max_depth+1 such traces — bound those at ~1M pool lanes per
        # chunk.  Without shadow traces the pool itself is the only
        # multiplier and 4x bigger chunks just amortize per-trace
        # binning/launch overhead.
        from crt_tpu.ops.shade_iter import default_banks

        shadow_traces = scene.num_lights > 0 and not settings.no_shadows
        budget = (1 << 20) if shadow_traces else (1 << 22)
        chunk = max(tile_sz, budget // default_banks(scene, settings))
    if chunk and chunk < R:
        chunk = max(tile_sz, (chunk // tile_sz) * tile_sz)
        pad = (-R) % chunk
        act = jnp.ones(R, bool)
        if pad:
            # Dead-ray padding: masked lanes are dropped from the trace
            # binning (no kernel work), unlike duplicating live rays.
            origins = jnp.concatenate([origins, origins[:pad]])
            dirs = jnp.concatenate([dirs, dirs[:pad]])
            rx = jnp.concatenate([rx, rx[:pad]])
            ry = jnp.concatenate([ry, ry[:pad]])
            act = jnp.concatenate([act, jnp.zeros(pad, bool)])
        n_chunks = (R + pad) // chunk

        def one_chunk(args):
            o, d, x, y, a = args
            return shade_fn(scene, settings, trace_fn, o, d, x, y, a,
                            gi_salt=gi_salt)

        color = jax.lax.map(
            one_chunk,
            (
                origins.reshape(n_chunks, chunk, 3),
                dirs.reshape(n_chunks, chunk, 3),
                rx.reshape(n_chunks, chunk),
                ry.reshape(n_chunks, chunk),
                act.reshape(n_chunks, chunk),
            ),
        ).reshape(-1, 3)[:R]
    else:
        color = shade_fn(
            scene, settings, trace_fn, origins, dirs, rx, ry,
            gi_salt=gi_salt,
        )
    return untile(color)  # make_tiler's untile already crops to [h, w]


@jax.jit
def _render_jit(scene: Scene, settings: RenderSettings,
                gi_salt=None) -> jnp.ndarray:
    return _render_flat(scene, settings, gi_salt)


def render_image_hwc(
    scene: Scene, settings: RenderSettings | None = None, jit: bool = True,
    gi_salt=None,
) -> jnp.ndarray:
    """Render to a [height, width, 3] float32 linear-color image.

    ``gi_salt`` (uint32 scalar, traced) forks the per-pixel GI sample
    streams — pass k of a progressive accumulation renders with salt k;
    salt 0 is bit-exact the plain render (see crt_tpu.progressive).
    """
    settings = settings or RenderSettings()
    if settings.aov:
        # First-class AOV setting: golden profiles (utils/golden.py) apply
        # verbatim through the public API — e.g. the 09-01 course golden is
        # the bary visualization pass, not beauty.
        return render_aov(scene, settings, aov=settings.aov, jit=jit)
    fn = _render_jit if jit else _render_flat
    return fn(scene, settings, gi_salt)


def render_image(
    scene: Scene, settings: RenderSettings | None = None, jit: bool = True,
    gi_salt=None,
) -> jnp.ndarray:
    """Alias of render_image_hwc — the ``crt::render_image`` equivalent."""
    return render_image_hwc(scene, settings, jit=jit, gi_salt=gi_salt)


def _render_aov_flat(scene: Scene, settings: RenderSettings, aov: str):
    from crt_tpu.ops.shade import hit_attributes
    from crt_tpu.ops.texture import sample_textures

    h, w = scene.height, scene.width
    # Same pixel-tile ray ordering as the beauty pass: the Pallas trace
    # bins per TILE_RAYS run, and pixel blocks give tight frustums where
    # scanline runs do not.
    rxf, ryf, untile = make_tiler(h, w)
    origins, dirs = camera_ops.generate_rays(
        scene.cam_position, scene.cam_rotation, scene.cam_tan_half_fov,
        w, h, rxf, ryf,
    )
    trace_fn = make_trace_fn(scene, settings)
    hit = trace_fn(origins, dirs, None)
    attrs = hit_attributes(scene, origins, dirs, hit, force_all=True)
    miss = ~attrs.valid[..., None]

    if aov == "bary":
        # Barycentric visualization — the 09-01 course-task render:
        # color = (bary_u, bary_v, 0) on hit, background on miss.
        out = jnp.stack(
            [attrs.bary_u, attrs.bary_v, jnp.zeros_like(attrs.bary_u)], -1
        )
    elif aov == "normal":
        out = attrs.normal * 0.5 + 0.5
    elif aov == "depth":
        out = jnp.repeat(attrs.t[..., None], 3, axis=-1)
    elif aov == "tri_id":
        tid = jax.lax.stop_gradient(hit.tri).astype(jnp.float32)
        out = jnp.stack(
            [tid % 256.0 / 255.0, (tid // 256.0) % 256.0 / 255.0,
             jnp.zeros_like(tid)], -1,
        )
    elif aov == "albedo":
        out = sample_textures(
            scene, attrs.albedo_tex, attrs.uv, attrs.bary_u, attrs.bary_v
        )
    else:
        raise ValueError(f"unknown aov {aov!r}")

    out = jnp.where(miss, scene.background_color, out)
    return untile(out)


@functools.partial(jax.jit, static_argnames=("aov",))
def _render_aov_jit(scene, settings, aov):
    return _render_aov_flat(scene, settings, aov)


def render_aov(
    scene: Scene,
    settings: RenderSettings | None = None,
    aov: str = "",
    jit: bool = True,
) -> jnp.ndarray:
    """Render an auxiliary output (AOV / debug pass) from primary hits.

    Available: "bary" (the 09-01 course visualization), "normal", "depth",
    "tri_id", "albedo".  ``aov`` defaults to ``settings.aov`` (then "bary").
    """
    settings = settings or RenderSettings()
    aov = aov or settings.aov or "bary"
    if jit:
        return _render_aov_jit(scene, settings, aov)
    return _render_aov_flat(scene, settings, aov)
