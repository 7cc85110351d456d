"""Repo-root pytest configuration: the doctest gate runs on the CPU.

``tests/conftest.py`` configures the test suite; this root conftest
covers the ``--doctest-modules`` gate (``make doctest``), whose
collection imports the package modules directly without loading the
tests/ conftest.
"""

import jax

jax.config.update("jax_platforms", "cpu")
