"""Where the program runs: the solver-implementation choice and the
persistent compile cache.

:func:`resolve_impl` is the one place that decides between a Pallas
kernel and the plain XLA program.  :func:`enable_compile_cache` is the
one place that points JAX's persistent compilation cache at a
directory.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

__all__ = [
    "KERNEL_FAMILIES", "KERNEL_MAX_RANK", "resolve_impl",
    "enable_compile_cache",
]

# Solver families with a hand-written Pallas (Triton) kernel that beat
# the XLA program on the GPU at the 1024 x 200 x 8, rank-4 batch.
KERNEL_FAMILIES = frozenset({"mu", "cd", "beta"})
# Largest (padded) rank "auto" sends to a kernel.  The kernels unroll
# k^2 L multiply-adds per update: on an H100 they beat XLA up to k=8,
# but compiling one takes ~12 s at k=4, ~45 s at k=6, ~2 min at k=8 and
# over 4 min at k=10.
KERNEL_MAX_RANK = 6

_IMPLS = ("auto", "xla", "pallas")


def resolve_impl(
    impl: str, family: str, *, rank: int = 1, penalized: bool = False,
    interpret: bool = False,
) -> str:
    """Resolve a solver ``impl`` request to ``"pallas"`` or ``"xla"``.

    ``"auto"`` picks the family's kernel only on a GPU, only when the
    family has one, the (padded) ``rank`` is at most
    :data:`KERNEL_MAX_RANK` and no L1/L2 penalty is asked for (the
    kernels do not implement penalties); it picks XLA everywhere else.
    An explicit ``"pallas"`` raises where the kernel cannot run: no
    kernel for the family, a penalty, or no GPU.  ``interpret=True``
    (tests only) admits the kernel off the GPU in Pallas' interpreter.
    """
    if impl not in _IMPLS:
        raise ValueError(f"unknown impl: {impl!r}; expected one of {_IMPLS}")
    on_gpu = jax.default_backend() == "gpu"
    has_kernel = family in KERNEL_FAMILIES
    if impl == "auto":
        small = rank <= KERNEL_MAX_RANK
        return (
            "pallas" if on_gpu and has_kernel and small and not penalized
            else "xla"
        )
    if impl == "xla":
        return "xla"
    if not has_kernel:
        raise ValueError(
            f"no Pallas kernel for the {family!r} solver; use impl='xla'"
        )
    if penalized:
        raise ValueError(
            "L1/L2 regularization is not supported by impl='pallas'; "
            "use impl='xla'"
        )
    if not (on_gpu or interpret):
        raise RuntimeError(
            "impl='pallas' runs Triton kernels, which need a GPU; the "
            f"default backend is {jax.default_backend()!r}. Use "
            "impl='auto' or impl='xla'."
        )
    return "pallas"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at a fixed directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and
    nothing is set here.  Otherwise the cache goes to ``.jax_cache`` at
    the root of the checkout (gitignored): a fixed path, since the path
    is part of the cache's key.  Returns the directory in use.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(Path(__file__).resolve().parents[2] / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
