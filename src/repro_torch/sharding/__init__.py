"""See the package docstring; modules are imported explicitly."""
