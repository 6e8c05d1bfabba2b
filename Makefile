# Build / test / bench entry points (reference Makefile:61-88 parity).
#
#   make native    - build the C++ host runtime (librdt_native.so)
#   make test      - full hermetic suite on a local 8-device CPU mesh
#   make test_fast - fast tier (excludes @pytest.mark.slow)
#   make test_gpu  - compiled Triton kernels against the jnp loops (GPU only)
#   make smoke     - chip_smoke.py: 1080p frame + train step + parity (GPU only)
#   make bench     - north-star benchmark (one JSON line, GPU only)
#   make run_no_args / make help - CLI usage (reference run_no_args)
#   make docs      - full API docs into build/docs (Doxygen analogue)
#   make clean

PY ?= python3

.PHONY: all native test test_fast test_gpu smoke bench run_no_args help docs clean

all: native test

native:
	$(PY) native/build.py

# -n 2 (pytest-xdist): two worker processes.  Besides the ~2x wall-time win,
# this bounds per-process XLA:CPU compilation count — a single long pytest
# process on this host segfaults inside XLA:CPU compile/load after ~150
# compiled executables (jax targets CPU features the host lacks: see the
# "Machine type used for XLA:CPU compilation doesn't match" warnings); every
# test passes in shorter-lived processes.
test:
	$(PY) -m pytest tests/ -q -n 2

# quick iteration signal: skips the long parity sweeps and sequence tests
# (marked @pytest.mark.slow) while keeping one representative of every
# kernel/parity family; `make test` remains the full pre-commit gate
test_fast:
	$(PY) -m pytest tests/ -q -m "not slow"

test_gpu:
	RDT_TEST_GPU=1 $(PY) -m pytest -m gpu tests/ -q

smoke:
	$(PY) chip_smoke.py

bench:
	$(PY) bench.py

run_no_args:
	$(PY) -m raymarchdenoiser.cli

help:
	$(PY) -m raymarchdenoiser.cli -h

docs:
	$(PY) tools/gendocs.py --out build/docs

clean:
	rm -rf build __pycache__ .pytest_cache native/librdt_native.so
	find . -name "__pycache__" -type d -prune -exec rm -rf {} \; 2>/dev/null || true
