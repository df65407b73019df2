# Reproducible environment for doppelspeller (reference Dockerfile:1-21,
# re-designed for a CUDA GPU host instead of a CPU workstation).
#
# The reference builds Python 3.7 + BLAS from source for its numba/XGBoost
# stack; this build needs none of that — it needs a pinned JAX with its
# CUDA 12 plugin and a C++ toolchain for the native host kernels
# (doppelspeller/native/, built on first use into the checkout's .cache/).
#
# Build:    docker build -t doppelspeller .
# Run on a GPU host (NVIDIA container toolkit):
#   docker run --gpus all -v $PWD/data:/data -e PROJECT_DATA_PATH=/data \
#       -it doppelspeller python chip_smoke.py
#
# CPU-only development (tests force the CPU backend via tests/conftest.py
# and an 8-device virtual mesh, so the full suite runs anywhere):
#   docker run -it doppelspeller make test

FROM python:3.12-slim-bookworm

ARG DEBIAN_FRONTEND=noninteractive

# g++ for the native host kernels (ctypes extension, built on first use);
# make for the dev targets.
RUN apt-get -y update \
    && apt-get -y install --no-install-recommends build-essential make git \
    && rm -rf /var/lib/apt/lists/*

# jax[cuda12] bundles the CUDA runtime libraries; on a machine without a GPU
# JAX falls back to the CPU backend (what the test suite uses).
RUN pip install --no-cache-dir "jax[cuda12]==0.9.0" "numpy==2.0.2" pytest coverage

WORKDIR /doppelspeller
COPY . .
RUN pip install --no-cache-dir -e .

# Persistent XLA compilation cache (the package enables it at import time);
# mount a volume here to keep compiles across container restarts.
ENV JAX_COMPILATION_CACHE_DIR=/var/cache/doppel_jax_cache
RUN mkdir -p /var/cache/doppel_jax_cache

ENV PROJECT_DATA_PATH=/data

CMD ["/bin/bash"]
