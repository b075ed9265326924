"""Start-up plumbing: compile-cache placement, the native library's build
key, the main path refusing to run without the native library, and the
device->host fetch helpers."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from go_jpeg2000_tpu.native import loader
from go_jpeg2000_tpu.utils import compile_cache, fetch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dir_in_subprocess(env_updates):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "JAX_PLATFORMS")}
    env.update(env_updates)
    code = ("import go_jpeg2000_tpu, jax; "
            "print(repr(jax.config.jax_compilation_cache_dir))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return r.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("case", ["variable_set", "unset_gpu", "cpu"])
def test_compile_cache_placement(tmp_path, case):
    """JAX_COMPILATION_CACHE_DIR is obeyed when set; otherwise a non-CPU
    run caches in the checkout's .jax_cache and a CPU run caches nowhere.
    Importing the package initializes no backend, so a GPU platform name
    is enough here."""
    if case == "variable_set":
        got = _cache_dir_in_subprocess(
            {"JAX_COMPILATION_CACHE_DIR": str(tmp_path), "JAX_PLATFORMS":
             "cuda"})
        assert got == repr(str(tmp_path))
    elif case == "unset_gpu":
        got = _cache_dir_in_subprocess({"JAX_PLATFORMS": "cuda"})
        assert got == repr(os.path.join(ROOT, ".jax_cache"))
        assert compile_cache.CACHE_DIR == os.path.join(ROOT, ".jax_cache")
    else:
        assert _cache_dir_in_subprocess({"JAX_PLATFORMS": "cpu"}) == "None"


@pytest.fixture
def fresh_loader(monkeypatch, tmp_path):
    """A loader with no library loaded, building into tmp_path; builds are
    faked by copying the real library (built once for this host)."""
    real = loader._so_path(loader._stamp())
    loader.require()
    built = []

    def fake_compile(so):
        built.append(so)
        os.makedirs(os.path.dirname(so), exist_ok=True)
        shutil.copy(real, so)
        return None

    monkeypatch.setattr(loader, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(loader, "_compile", fake_compile)
    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "_build_error", None)
    return built


def test_loader_rebuilds_when_stamp_differs(fresh_loader, monkeypatch):
    monkeypatch.setattr(loader, "_stamp", lambda: "a" * 20)
    assert loader.available()
    assert fresh_loader == [loader._so_path("a" * 20)]
    # same stamp in a new process: the existing build is reused
    monkeypatch.setattr(loader, "_lib", None)
    assert loader.available()
    assert len(fresh_loader) == 1
    # sources, compiler or host changed: a new build
    monkeypatch.setattr(loader, "_stamp", lambda: "b" * 20)
    monkeypatch.setattr(loader, "_lib", None)
    assert loader.available()
    assert fresh_loader[-1] == loader._so_path("b" * 20)


def test_loader_never_loads_a_foreign_library(fresh_loader, tmp_path):
    """A library built on another host carries another stamp; a corrupt
    file under a foreign stamp is ignored and this host builds its own."""
    foreign = tmp_path / "j2k_native-0123456789abcdef0123.so"
    foreign.write_bytes(b"not a library")
    assert loader.available()
    assert fresh_loader == [loader._so_path(loader._stamp())]


def test_stamp_keys_on_host(monkeypatch):
    stamp = loader._stamp()
    monkeypatch.setattr(loader, "_host_id", lambda: "another-host")
    assert loader._stamp() != stamp


def _small_frames():
    rng = np.random.RandomState(3)
    return [rng.randint(0, 256, size=(32, 32)).astype(np.uint8)
            for _ in range(2)]


@pytest.mark.parametrize("entry", ["encode_batch_ht", "encode_ebcot",
                                   "decode"])
def test_main_path_raises_without_native(monkeypatch, entry):
    """backend='auto' and every decode raise with the build error when the
    native library is missing, instead of running the Python coder."""
    import go_jpeg2000_tpu as jp2k
    from go_jpeg2000_tpu.models.encoder import encode_batch
    from go_jpeg2000_tpu.options import Format, Options

    frames = _small_frames()
    data = jp2k.encode(frames[0], Options(format=Format.J2K, lossless=True,
                                          num_resolutions=3))
    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "_build_error", "g++: command not found")
    with pytest.raises(loader.NativeUnavailable, match="g\\+\\+"):
        if entry == "encode_batch_ht":
            encode_batch(frames, Options(format=Format.J2K, lossless=True,
                                         num_resolutions=3,
                                         high_throughput=True))
        elif entry == "encode_ebcot":
            jp2k.encode(frames[0], Options(format=Format.J2K, lossless=True,
                                           num_resolutions=3))
        else:
            jp2k.decode(data)


def test_python_backend_needs_no_native(monkeypatch):
    import go_jpeg2000_tpu as jp2k
    from go_jpeg2000_tpu.options import Format, Options
    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "_build_error", "g++: command not found")
    data = jp2k.encode(_small_frames()[0],
                       Options(format=Format.J2K, lossless=True,
                               num_resolutions=3, backend="python"))
    assert data[:2] == b"\xff\x4f"


def test_fetch_gather_host_array_passes_through():
    x = np.arange(10, dtype=np.int16)
    h = fetch.fetch_async(x)
    assert h is x
    np.testing.assert_array_equal(fetch.gather(h), x)


def test_fetch_gather_device_array():
    import jax.numpy as jnp
    x = jnp.arange(3 << 18, dtype=jnp.uint32) * 3
    out = fetch.gather(fetch.fetch_async(x))
    assert isinstance(out, np.ndarray) and out.dtype == np.uint32
    np.testing.assert_array_equal(out, np.arange(3 << 18,
                                                 dtype=np.uint32) * 3)
