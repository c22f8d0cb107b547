"""Version info, the port's copy of `pvio_tpu/version.py` (reference:
pvio/include/pvio/version.h)."""

version_info = (0, 1, 0)
__version__ = ".".join(map(str, version_info))
