"""Package version (the JAX package's version.py)."""

__version__ = "0.3.0"
