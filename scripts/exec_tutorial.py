#!/usr/bin/env python
"""Execute docs/tutorial.ipynb end-to-end (executable-docs gate).

The reference's tutorials are its only executable documentation and
nothing runs them (SURVEY §4); here the notebook executes in CI via
nbclient so the docs cannot silently rot.  Exit 0 = every code cell
ran.

Usage: python scripts/exec_tutorial.py [--platform cpu] [notebook.ipynb]
"""

import argparse
import os
import sys

import nbformat
from nbclient import NotebookClient

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("notebook", nargs="?",
                        default=os.path.join(HERE, "docs", "tutorial.ipynb"))
    parser.add_argument("--platform", default=None,
                        help="JAX platform for the notebook's kernel")
    args = parser.parse_args(argv)
    path = args.notebook
    nb = nbformat.read(path, as_version=4)
    # the notebook runs in its own kernel process: a first cell selects
    # the platform there before any device query
    platform = args.platform
    if platform:
        nb.cells.insert(
            0,
            nbformat.v4.new_code_cell(
                "import jax\n"
                f"jax.config.update('jax_platforms', {platform!r})\n"
            ),
        )
    client = NotebookClient(
        nb,
        timeout=900,
        kernel_name="python3",
        resources={"metadata": {"path": HERE}},
    )
    client.execute()
    n_code = sum(1 for c in nb.cells if c.cell_type == "code")
    print(f"executed {n_code} code cells of {os.path.basename(path)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
