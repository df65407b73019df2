# Developer entry points (reference parity: Makefile:1-40, minus Docker —
# the program runs directly on the host that holds the GPU).

PYTHON ?= python

.PHONY: test test-heavy test-all test-gpu lint stage-example-data build-index \
        train-model generate-predictions closest-search \
        get-predictions-accuracy bench chip-smoke

# Test lanes (CPU, virtual 8-device mesh; tests/conftest.py):
#   make test       fast lane (skips `heavy` and `slow`)
#   make test-heavy compile-bound integration tests
#   slow lane       full CPU train→predict example-dataset parity runs
#                   (needs the reference example dataset)
#   make test-gpu   tests that compile kernels for a CUDA GPU
# `make test-all` runs the three CPU lanes.
test:
	$(PYTHON) -m pytest tests/ -q -m 'not slow and not heavy'

test-heavy:
	$(PYTHON) -m pytest tests/ -q -m 'heavy'

test-all:
	$(PYTHON) -m pytest tests/ -q -m ''

test-gpu:
	DOPPEL_TEST_GPU=1 $(PYTHON) -m pytest tests/ -q -m gpu

chip-smoke:
	$(PYTHON) chip_smoke.py

lint:
	$(PYTHON) scripts/lint.py

# tests under coverage (reference setup.cfg always-on --cov; opt-in here so
# the plain `make test` loop stays fast).  Requires `coverage` (not in the
# hermetic dev image — degrades to plain pytest with a notice).
test-cov:
	@$(PYTHON) -c "import coverage" 2>/dev/null \
	  && { $(PYTHON) -m coverage run -m pytest tests/ -q && $(PYTHON) -m coverage report; } \
	  || { echo "coverage not installed; running plain pytest"; $(PYTHON) -m pytest tests/ -q; }

# full train -> predict -> accuracy on the reference example dataset;
# asserts custom error <= 700 (reproducible parity)
example-parity:
	$(PYTHON) scripts/example_parity.py

stage-example-data:
	$(PYTHON) -m doppelspeller.cli stage-example-data-set

build-index:
	$(PYTHON) -m doppelspeller.cli -vv build-index

train-model:
	$(PYTHON) -m doppelspeller.cli -vv train-model

generate-predictions:
	$(PYTHON) -m doppelspeller.cli -vv generate-predictions

# usage: make closest-search title="SOME TITLE"
closest-search:
	$(PYTHON) -m doppelspeller.cli -vv closest-search-single-title -t "$(title)"

get-predictions-accuracy:
	$(PYTHON) -m doppelspeller.cli -vv get-predictions-accuracy

bench:
	$(PYTHON) bench.py
