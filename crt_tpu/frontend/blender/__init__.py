"""Blender add-on: render with the crt_tpu ray tracer.

Functional counterpart of the reference add-on (reference src/blender/:
engine, json bridge, properties, UI, ops) rebuilt against the crt_tpu
Python API instead of the C++ ``_crt`` module.  Install by zipping this
directory (with crt_tpu importable) or pointing Blender's scripts path at
the repo.

Only importable inside Blender (requires ``bpy``).
"""

bl_info = {
    "name": "CRT-TPU Renderer",
    "author": "crt_tpu",
    "version": (0, 1, 0),
    "blender": (4, 5, 0),
    "description": "CRT ray tracer (JAX) render engine + .crtscene IO",
    "category": "Render",
}


def register():
    from crt_tpu.frontend.blender import engine, ops, properties, ui

    properties.register()
    engine.register()
    ui.register()
    ops.register()


def unregister():
    from crt_tpu.frontend.blender import engine, ops, properties, ui

    ops.unregister()
    ui.unregister()
    engine.unregister()
    properties.unregister()
