"""Backend selection, the compile-cache location, and chip_smoke.py's
refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest

from doppelspeller import backend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dev(platform):
    return SimpleNamespace(platform=platform)


def test_cpu_takes_the_plain_routes():
    import jax

    cpu = jax.devices()[0]
    assert backend.platform(cpu) == "cpu"
    assert backend.platform() == "cpu"           # JAX's default device here
    assert backend.coarse_route(cpu) == "xla"
    assert backend.index_build_route(cpu) == "host"
    assert backend.histogram_route(cpu) == "scatter"


@pytest.mark.parametrize("name", ["gpu", "cuda"])
def test_gpu_takes_the_device_routes(name):
    gpu = _dev(name)
    assert backend.platform(gpu) == "gpu"
    assert backend.coarse_route(gpu) == "triton"
    assert backend.index_build_route(gpu) == "device"
    assert backend.histogram_route(gpu) == "matmul"


@pytest.mark.parametrize("name", ["rocm", "METAL", "interpreter"])
def test_unknown_platform_raises(name):
    for fn in (backend.platform, backend.coarse_route,
               backend.index_build_route, backend.histogram_route):
        with pytest.raises(RuntimeError, match="unsupported JAX platform"):
            fn(_dev(name))


def test_coarse_route_follows_config():
    """retrieval_impl 'auto' takes the backend's route only where the kernel
    computes the configured scores (bf16 windowed maxima)."""
    import jax

    from doppelspeller.config import Config
    from doppelspeller.ops.fold import resolve_coarse_route

    cpu, gpu = jax.devices()[0], _dev("gpu")
    cfg = Config(data_path="/tmp/x")
    assert resolve_coarse_route(cfg, gpu) == "triton"
    assert resolve_coarse_route(cfg, cpu) == "xla"
    assert resolve_coarse_route(cfg.with_(score_dtype="float32"), gpu) == "xla"
    assert resolve_coarse_route(
        cfg.with_(retrieval_window_select=False), gpu) == "xla"
    assert resolve_coarse_route(cfg.with_(retrieval_impl="xla"), gpu) == "xla"
    with pytest.raises(ValueError):
        resolve_coarse_route(
            cfg.with_(retrieval_impl="triton", score_dtype="float32"), gpu)
    with pytest.raises(ValueError):
        resolve_coarse_route(cfg.with_(retrieval_impl="pallas"), gpu)


def _cache_dir_in_fresh_process(env_value):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    out = subprocess.run(
        [sys.executable, "-c",
         "import doppelspeller, jax; "
         "print(jax.config.jax_compilation_cache_dir); "
         "print(doppelspeller.compile_cache_dir())"],
        env=env, capture_output=True, text=True, timeout=120, cwd="/",
    )
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


def test_compile_cache_honours_env(tmp_path):
    want = str(tmp_path / "jaxcache")
    assert _cache_dir_in_fresh_process(want) == [want, want]


def test_compile_cache_defaults_to_checkout():
    want = os.path.join(REPO, ".jax_cache")
    assert _cache_dir_in_fresh_process(None) == [want, want]
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def _smoke(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu_only_host():
    out = _smoke(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a CUDA GPU" in out.stderr


def test_chip_smoke_refuses_without_the_repo(tmp_path):
    """Alone in a directory the script cannot run the program: past the
    device check (the rehearsal skips it here) the import fails."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _smoke(tmp_path, "--cpu-rehearsal")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "ModuleNotFoundError" in out.stderr
