"""Cross-cutting helpers: error classes, verbosity streams, help catalogs."""

from . import errors, output

__all__ = ["errors", "output"]
