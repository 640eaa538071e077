"""frontend (see the package docstring)."""
