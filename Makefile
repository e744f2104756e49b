# Convenience targets mirroring the reference build entries
# (reference Makefile: standalone | python | blender | clean).

PYTHON ?= python

.PHONY: all native test bench golden smoke blender-zip clean

all: native

# native helper library (KD builder) — the "standalone core" build
native:
	$(PYTHON) native/build.py

test:
	JAX_PLATFORMS=cpu $(PYTHON) -m pytest tests/ -x -q

bench: native
	$(PYTHON) bench.py

golden: native
	$(PYTHON) tools/golden_check.py

# end-to-end check of the render path on one GPU
smoke:
	$(PYTHON) chip_smoke.py

# stage the Blender add-on as an installable zip (bundles crt_tpu)
blender-zip:
	$(PYTHON) tools/stage_blender_addon.py

clean:
	rm -f native/libcrt_accel.so crt_tpu_blender.zip
	rm -rf .jax_cache
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true
