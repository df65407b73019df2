"""Backend selection: the one place that maps a device's platform to the
kernel route each stage takes.

Two platforms are supported: ``"gpu"`` (CUDA) and ``"cpu"``.  Any other
platform is an error — a route is never guessed.  Every stage that has more
than one implementation asks this module, passing the device (or the first
device of its mesh) it will run on; with no device it asks about JAX's
default device.
"""

from __future__ import annotations

import jax

_PLATFORMS = {"cpu": "cpu", "gpu": "gpu", "cuda": "gpu"}


def platform(device=None) -> str:
    """``"gpu"`` or ``"cpu"`` for ``device`` (default: JAX's first device)."""
    dev = device if device is not None else jax.devices()[0]
    try:
        return _PLATFORMS[dev.platform]
    except KeyError:
        raise RuntimeError(
            f"unsupported JAX platform {dev.platform!r} (device {dev}); "
            f"supported: {sorted(set(_PLATFORMS.values()))}"
        ) from None


def coarse_route(device=None) -> str:
    """Folded coarse scorer: the Pallas-Triton kernel on the GPU
    (ops/coarse_triton.py), the plain XLA scorer on the CPU."""
    return "triton" if platform(device) == "gpu" else "xla"


def index_build_route(device=None) -> str:
    """Packed-index construction: on the device on the GPU (only the encoded
    titles cross the host link), host numpy/C++ on the CPU."""
    return "device" if platform(device) == "gpu" else "host"


def histogram_route(device=None) -> str:
    """GBT histograms: one multi-hot matmul on the GPU, segment sums on the
    CPU (where the multi-hot matmul is far slower than a scatter)."""
    return "matmul" if platform(device) == "gpu" else "scatter"
