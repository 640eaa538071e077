"""train (see the package docstring)."""
