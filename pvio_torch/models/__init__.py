"""Model presets (see presets.py)."""

from pvio_torch.models.presets import (  # noqa: F401
    PRESETS, build, config, euroc, fast, tum_vi, vio_no_planes,
)
