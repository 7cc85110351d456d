"""Optional dependencies, imported on first use.

pandas serves only the DataFrame surface (frame-returning analysis
helpers, the reference-compatible result objects, the pandas CSV
reader fallback).  The array path — native CSV decode, device
preprocessing, the batched solvers and export — runs without it, so
the package imports it here lazily instead of at module level.
"""

from __future__ import annotations

import importlib
import sys

__all__ = ["pandas", "is_pandas"]


class _LazyModule:
    """Module proxy that imports its target on first attribute access."""

    def __init__(self, name: str, purpose: str):
        self._name = name
        self._purpose = purpose

    def __getattr__(self, attr):
        try:
            module = importlib.import_module(self._name)
        except ImportError as exc:
            raise ImportError(
                f"{self._name} is required for {self._purpose}; the array "
                "API (numpy/jax inputs and outputs) runs without it"
            ) from exc
        return getattr(module, attr)


pandas = _LazyModule("pandas", "DataFrame and Series input and output")


def is_pandas(x) -> bool:
    """True for a pandas DataFrame or Series, without importing pandas.

    An object can only be a pandas object if pandas is already loaded.
    """
    pd = sys.modules.get("pandas")
    return pd is not None and isinstance(x, (pd.DataFrame, pd.Series))
