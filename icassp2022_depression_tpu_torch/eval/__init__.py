"""eval (see the package docstring)."""
