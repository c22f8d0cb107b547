"""Public PVIO facade: three sensor entry points + map queries.

Matches `pvio_tpu/api.py`: `OutputPose`, `OutputState`, `OutputMapPoint`,
`OutputPlane` and `PVIO` (`track_gyroscope`, `track_accelerometer`,
`track_camera`, `initialized`, `get_latest_state`, `finish`,
`get_trajectory`, `get_map_points`, `get_planes`, `reset`).

`PVIO(config, enable_planes=None, device=None)` runs on CUDA and raises
when CUDA is absent, unless `device="cpu"` is passed. With
`config.enable_plane_constraint` (the default) the engine builds a
`PlaneExtractor` on its own `DeviceKernels` through `Core`'s
`plane_extractor_factory`, as the reference does (`pvio_tpu/api.py:59-67`).
`reset` keeps the engine's `DeviceKernels` (the reference reuses its
compile cache there); the reset engine gets a fresh extractor.
"""

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from pvio_torch.core.core import Core
from pvio_torch.core.kernels import DeviceKernels
from pvio_torch.core.plane_extractor import PlaneExtractor
from pvio_torch.map.window import TF_PLANE, TF_VALID
from pvio_torch.utils import transfer


@dataclass
class OutputPose:
    t: float
    q: np.ndarray  # (4,) wxyz
    p: np.ndarray  # (3,)


@dataclass
class OutputState:
    t: float
    q: np.ndarray
    p: np.ndarray
    v: np.ndarray
    bg: np.ndarray
    ba: np.ndarray


@dataclass
class OutputMapPoint:
    p: np.ndarray
    reserved: int = 0


@dataclass
class OutputPlane:
    normal: np.ndarray
    distance: float
    reference_point: np.ndarray = field(default_factory=lambda: np.zeros(3))


class PVIO:
    """Monocular visual-inertial odometry engine: feed `track_gyroscope` /
    `track_accelerometer` at sensor rate and `track_camera` per frame;
    each call returns the latest predicted OutputPose (or None before
    initialization completes)."""

    def __init__(self, config, enable_planes: Optional[bool] = None, device=None):
        if enable_planes is not None:
            config.enable_plane_constraint = enable_planes
        self.config = config
        self.core = self._build_core(DeviceKernels(config, device))

    def _build_core(self, kernels):
        factory = None
        if self.config.enable_plane_constraint:
            def factory():
                return PlaneExtractor(self.config, kernels)
        return Core(self.config, plane_extractor_factory=factory, kernels=kernels)

    def reset(self):
        """Drop all estimator state and restart from scratch, on the same
        DeviceKernels."""
        self.core = self._build_core(self.core.kernels)

    # --- sensor entry points ---
    def track_gyroscope(self, t, x, y, z) -> Optional[OutputPose]:
        return self._pose(self.core.track_gyroscope(t, x, y, z))

    def track_accelerometer(self, t, x, y, z) -> Optional[OutputPose]:
        return self._pose(self.core.track_accelerometer(t, x, y, z))

    def track_camera(self, t, image) -> Optional[OutputPose]:
        return self._pose(self.core.track_camera(t, image))

    @staticmethod
    def _pose(out):
        if out is None:
            return None
        t, q, p = out
        return OutputPose(t=t, q=np.asarray(q), p=np.asarray(p))

    # --- state / map queries ---
    @property
    def initialized(self) -> bool:
        return self.core.frontend.initialized

    def get_latest_state(self) -> Optional[OutputState]:
        swt = self.core.frontend.swt
        if swt is None:
            return None
        t, q, p, v, bg, ba = swt.latest_state
        return OutputState(t=t, q=q, p=p, v=v, bg=bg, ba=ba)

    def finish(self):
        """Drain any in-flight pipelined stages (end of stream)."""
        self.core.flush()

    def get_trajectory(self):
        """Per-frame optimized outputs [(t, q, p)] so far, after draining
        the host pipeline."""
        self.core.flush()
        return list(self.core.outputs)

    def get_map_points(self):
        swt = self.core.frontend.swt
        if swt is None:
            return []
        hw = swt.hw
        pts = transfer.get(self.core.kernels.landmarks(hw.to_device()))
        out = []
        for c in np.nonzero(hw.track_mask)[0]:
            if hw.track_flags[c] & (TF_VALID | TF_PLANE):
                out.append(OutputMapPoint(p=pts[c]))
        return out

    def get_planes(self):
        swt = self.core.frontend.swt
        if swt is None:
            return []
        hw = swt.hw
        return [OutputPlane(normal=hw.plane_normal[i].copy(), distance=float(hw.plane_distance[i]))
                for i in np.nonzero(hw.plane_mask)[0]]
