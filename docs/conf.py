# Sphinx configuration (reference parity: docs/conf.py + .readthedocs.yaml
# in trails-phylogeny/itrails; the content here is the handwritten markdown
# rendered through myst-parser, plus autodoc API pages).
import os
import sys

sys.path.insert(0, os.path.abspath(".."))

project = "itrails-tpu"
author = "itrails-tpu developers"

extensions = [
    "myst_parser",
    "sphinx.ext.autodoc",
    "sphinx.ext.napoleon",
    "sphinx.ext.viewcode",
]

source_suffix = {".rst": "restructuredtext", ".md": "markdown"}
master_doc = "index"
exclude_patterns = ["_build"]

html_theme = "furo"

autodoc_mock_imports = [
    "jax", "jaxlib", "numpy", "scipy",
]
