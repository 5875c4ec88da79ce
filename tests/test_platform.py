"""flutpu.platform: the one module that reads the JAX backend and picks
every arm from it, and the compile-cache helper every entry point calls."""

import importlib
import os

import jax
import numpy as np
import pytest

from flutpu import platform

ARMS = {
    # platform: (dct_planar, pack_kernel, interpret, segmented, device
    #            entropy, grow_async)
    "cpu": (False, False, True, False, False, False),
    "gpu": (False, True, False, True, True, True),
}


@pytest.mark.parametrize("name", sorted(ARMS))
def test_arms_per_platform(monkeypatch, name):
    monkeypatch.setattr(jax, "default_backend", lambda: name)
    assert platform.name() == name
    got = (platform.dct_planar(), platform.pack_kernel(),
           platform.interpret_kernels(), platform.segmented_default(),
           platform.device_entropy(), platform.grow_async())
    assert got == ARMS[name]
    assert platform.matmul_precision() == jax.lax.Precision.HIGHEST
    # an explicit request overrides the packer default either way
    assert platform.pack_kernel(True) is True
    assert platform.pack_kernel(False) is False


@pytest.mark.parametrize("other", ["tpu", "rocm", "METAL"])
def test_unknown_platform_is_an_error_naming_it(monkeypatch, other):
    monkeypatch.setattr(jax, "default_backend", lambda: other)
    with pytest.raises(RuntimeError, match=repr(other)):
        platform.name()
    with pytest.raises(RuntimeError):
        platform.dct_planar()


def test_import_asks_no_backend(monkeypatch):
    """Importing the module makes no decision: a process may choose its
    platform after importing flutpu."""
    def boom():
        raise AssertionError("default_backend read at import")
    monkeypatch.setattr(jax, "default_backend", boom)
    importlib.reload(platform)


def test_decision_follows_the_backend_at_call_time(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert platform.interpret_kernels()
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert not platform.interpret_kernels()


def test_encoder_takes_its_arms_from_the_platform(monkeypatch):
    from flutpu.codec.jpeg import JpegEncoder, resolve_segmented
    monkeypatch.delenv("FLUTPU_SEGMENTED", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    enc = JpegEncoder(quality=85)
    assert enc.use_pallas is True
    assert enc.segmented is platform.segmented_default()
    assert enc._grow_async() is True
    assert resolve_segmented(None, False) is False   # scan: block concat
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    enc = JpegEncoder(quality=85)
    assert enc.use_pallas is False and enc.segmented is False
    assert enc._grow_async() is False


@pytest.mark.parametrize("planar", [False, True])
def test_fvc_header_flag_follows_the_platform_formulation(monkeypatch,
                                                          planar):
    """Header flags bit 3 comes from the same decision as the in-loop
    reconstruction, so the host decoder reconstructs through the
    formulation the encode used."""
    from flutpu.codec.fvc import FvcDecoder, FvcEncoder
    monkeypatch.setattr(platform, "dct_planar", lambda: planar)
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, size=(3, 32, 48, 3)).astype(np.uint8)
    enc = FvcEncoder(quality=85, motion=True, search_range=2)
    assert enc.planar is planar
    data = enc.encode_chunk(frames)
    assert bool(data[5] & 8) is planar
    out, _ = FvcDecoder().decode_chunk(data)
    assert out.shape == frames.shape


def test_compile_cache_uses_the_env_dir(monkeypatch, tmp_path):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    want = str(tmp_path / "cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    assert platform.enable_compile_cache(0.5) == want
    assert calls["jax_compilation_cache_dir"] == want
    assert calls["jax_persistent_cache_min_compile_time_secs"] == 0.5
    assert os.path.isdir(want)


def test_compile_cache_default_is_inside_the_checkout(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = platform.enable_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        platform.__file__)))
    assert path == platform.DEFAULT_CACHE_DIR
    assert os.path.dirname(path) == root
    assert calls["jax_compilation_cache_dir"] == path


def test_compile_cache_default_is_git_ignored():
    root = os.path.dirname(platform.DEFAULT_CACHE_DIR)
    with open(os.path.join(root, ".gitignore")) as f:
        ignored = {line.strip() for line in f}
    name = os.path.basename(platform.DEFAULT_CACHE_DIR)
    assert name + "/" in ignored or name in ignored
