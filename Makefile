# Development targets.

PYTHON ?= python

.PHONY: test test-fast bench bench-quick bench-vaf bench-check smoke \
	smoke-4 lint doctest check docs-exec entry native dist clean

test:
	$(PYTHON) -m pytest tests/ -q

test-fast:
	$(PYTHON) -m pytest tests/ -q -x --ignore=tests/test_parallel.py

lint:  # stdlib-only static checks (see scripts/lint.py)
	$(PYTHON) scripts/lint.py

doctest:  # run every docstring example (the reference's --doctest-modules gate)
	JAX_PLATFORMS=cpu $(PYTHON) -m pytest --doctest-modules \
		muscle_synergies_tpu muscle_synergies -q -p no:cacheprovider

check: lint  # full static gate: lint + bytecode-compile + optional mypy/pylint
	$(PYTHON) -m compileall -q muscle_synergies_tpu muscle_synergies \
		tests scripts benchmarks examples bench.py chip_smoke.py \
		__graft_entry__.py
	@command -v mypy >/dev/null 2>&1 \
		&& mypy --ignore-missing-imports muscle_synergies_tpu \
		|| echo "mypy not installed; skipped"

docs-exec:  # executable documentation: example script + tutorial notebook
	JAX_PLATFORMS=cpu XLA_FLAGS="--xla_force_host_platform_device_count=8" \
		$(PYTHON) examples/full_workflow.py --platform cpu
	$(PYTHON) scripts/gen_tutorial_nb.py  # notebook follows tutorial.md
	XLA_FLAGS="--xla_force_host_platform_device_count=8" \
		$(PYTHON) scripts/exec_tutorial.py --platform cpu

bench:
	$(PYTHON) bench.py

bench-quick:
	$(PYTHON) bench.py --quick

bench-vaf:  # time-to-90%-VAF on the calibrated gait batch
	$(PYTHON) bench.py --metric vaf --rank 2

bench-check:  # the device's solver numerics vs float64 references
	$(PYTHON) bench.py --check

smoke:  # the dataset path on one GPU, every phase checked
	$(PYTHON) chip_smoke.py

smoke-4:  # the sharded dataset path on four GPUs
	$(PYTHON) chip_smoke.py --chips 4

entry:
	JAX_PLATFORMS=cpu XLA_FLAGS="--xla_force_host_platform_device_count=8" \
		$(PYTHON) __graft_entry__.py

native:
	g++ -O3 -shared -fPIC -pthread \
		-o muscle_synergies_tpu/native/libvicon_decode.so \
		muscle_synergies_tpu/native/vicon_decode.cpp

dist:
	./scripts/check_dist.sh

clean:
	rm -rf muscle_synergies_tpu/native/libvicon_decode.so \
		$$(find . -name __pycache__ -type d) .pytest_cache
