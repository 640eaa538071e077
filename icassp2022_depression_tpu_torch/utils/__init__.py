"""utils (see the package docstring)."""
