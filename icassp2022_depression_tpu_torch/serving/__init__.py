"""serving (see the package docstring)."""
