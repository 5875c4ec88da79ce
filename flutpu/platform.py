"""The platform the program runs on, and every arm chosen from it.

This module is the only place that asks JAX which backend runs the
program. flutpu runs on two platforms: ``"cpu"`` (tests and the host
decoder) and ``"gpu"`` (one NVIDIA H100, or four on one host). Any other
backend is an error that names it.

Every decision is made when a function is called — never at import — so
a process that picks its platform after importing flutpu (tests, the
virtual-mesh rehearsal) gets the arms of that platform.

The arms, per platform:

- the DCT formulation: 8x8 block einsums (``plane_dct``) or the
  block-diagonal plane matmuls (``plane_dct_planar``). FVC writes the
  formulation its in-loop reconstruction used into the chunk header
  (flags bit 3), so encoder and header follow this one decision;
- the matmul precision of every DCT/IDCT and colour-matrix product;
- the entropy packer: the Pallas kernel (``ops/pack_kernel.py``, compiled
  through Triton on the GPU, run in interpret mode on the CPU) or the
  plain ``lax.scan`` packer;
- the default bit-stream layout of the device entropy stage (segment
  layout or block concatenation; both are byte-identical).

Motion compensation has one form (the flat gather of ``ops/motion.py``),
so there is nothing to choose there.
"""

from __future__ import annotations

import os

SUPPORTED = ("cpu", "gpu")

# Per-platform arms. The GPU column is what the H100 measured fastest
# end to end (chip_smoke.py phases 3 and 4; PERF.md "Where the time
# goes"); the CPU column keeps the suite cheap and exact.
_ARMS = {
    "cpu": {"dct_planar": False, "pack_kernel": False, "segmented": False},
    "gpu": {"dct_planar": False, "pack_kernel": True, "segmented": True},
}


def name() -> str:
    """``"cpu"`` or ``"gpu"``: the backend JAX runs this program on."""
    import jax
    p = jax.default_backend()
    if p not in SUPPORTED:
        raise RuntimeError(
            f"unsupported JAX platform {p!r}: flutpu runs on "
            f"{' and '.join(SUPPORTED)} only")
    return p


def device_kind() -> str:
    """The accelerator's model name as JAX reports it."""
    import jax
    name()
    return jax.devices()[0].device_kind


def dct_planar() -> bool:
    """True: block-diagonal plane matmuls; False: 8x8 block einsums."""
    return _ARMS[name()]["dct_planar"]


def matmul_precision():
    """Precision of every DCT/IDCT and colour-matrix product. HIGHEST
    because a float32 product at lower precision may run in TF32 on the
    GPU (about three decimal digits), and FVC's P-frame chain would then
    drift from the host decoder's reconstruction."""
    import jax
    return jax.lax.Precision.HIGHEST


def pack_kernel(requested=None) -> bool:
    """Whether the entropy stage packs bits with the Pallas kernel
    (True) or the ``lax.scan`` packer (False); ``requested`` overrides
    the platform default."""
    if requested is not None:
        return bool(requested)
    return _ARMS[name()]["pack_kernel"]


def interpret_kernels() -> bool:
    """Pallas kernels run in interpret mode on the CPU and compiled
    through Triton on the GPU; never interpreted on the card."""
    return name() == "cpu"


def segmented_default() -> bool:
    """Default bit-stream layout of the device entropy stage."""
    return _ARMS[name()]["segmented"]


def device_entropy() -> bool:
    """Whether encoders that can choose (``tpuhype``) pack entropy on the
    device: on the card only — on the CPU the host C++ coder is faster."""
    return name() == "gpu"


def grow_async() -> bool:
    """Whether grown static sizes compile on a background thread (the
    card: a compile costs seconds) or synchronously (the CPU: compiles
    are cheap and synchronous adoption keeps tests deterministic)."""
    return name() == "gpu"


_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: where the persistent compile cache lives when JAX_COMPILATION_CACHE_DIR
#: is unset: one fixed path inside the checkout (listed in .gitignore)
DEFAULT_CACHE_DIR = os.path.join(_REPO_ROOT, ".jax_cache")


def enable_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is and no other
    directory is set. Otherwise the cache sits at ``DEFAULT_CACHE_DIR``.
    Every entry point calls this before its first compile."""
    import jax
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_secs))
    return path
