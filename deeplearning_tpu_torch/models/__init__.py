"""Model zoo of the port; importing it registers every factory in
``core.registry.MODELS``."""

from . import classification, detection  # noqa: F401
