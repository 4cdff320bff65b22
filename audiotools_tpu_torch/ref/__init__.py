"""Scalar oracles of the port, copied from the reference package's
``ref/`` (see each module)."""
