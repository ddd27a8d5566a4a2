PY ?= python

.PHONY: test bench smoke native example lint clean

test:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -q

native:
	$(PY) -m smart_crossover_tpu.native.build

bench:
	$(PY) bench.py

smoke:
	$(PY) chip_smoke.py

example:
	JAX_PLATFORMS=cpu $(PY) examples/example.py

clean:
	rm -rf build *.egg-info smart_crossover_tpu/native/libscxnative.so .jax_cache
	find . -name __pycache__ -type d -exec rm -rf {} +
