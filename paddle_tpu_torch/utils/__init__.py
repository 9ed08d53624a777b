"""Utilities of the port: ``convert`` (weights across the packages) and
``unique_name``."""
from . import unique_name  # noqa: F401
