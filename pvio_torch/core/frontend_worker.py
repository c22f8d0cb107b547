"""Frontend worker: initializer <-> sliding-window-tracker state machine.

Matches `pvio_tpu/core/frontend_worker.py`: `FrontendWorker` (`issue_frame`,
`issue_dispatch`, `finish_issued`, `_reinit`). It runs the Initializer
until it succeeds, then hands the window to a SlidingWindowTracker; when
tracking fails it falls back to a fresh Initializer, whose RANSAC key
stream restarts from the configured seed.
"""

from pvio_torch.core.initializer import Initializer
from pvio_torch.core.swt import SlidingWindowTracker


class FrontendWorker:
    def __init__(self, config, kernels, feature_tracker, plane_extractor_factory=None):
        self.cfg = config
        self.k = kernels
        self.ft = feature_tracker
        self.initializer = Initializer(config, kernels)
        self.swt = None
        self._pef = plane_extractor_factory
        self.n_reinits = 0

    @property
    def initialized(self):
        return self.swt is not None

    def issue_frame(self, raw_frame):
        """Process one tracked frame; returns the latest optimized state
        tuple or None while uninitialized."""
        if self.swt is None:
            hw = self.initializer.try_initialize(self.ft.frames)
            if hw is None:
                return None
            planes = self._pef() if self._pef else None
            self.swt = SlidingWindowTracker(self.cfg, self.k, hw, self.ft, planes)
            self.ft.initialized = True
            return self.swt.latest_state
        ok = self.swt.track(raw_frame)
        if not ok:
            self._reinit()
            return None
        return self.swt.latest_state

    # -- pipelined variants (the reference's threaded worker handoff,
    # utility/worker.h:25-78: the tracker runs ahead while the sliding-
    # window solve of the previous frame completes) --
    def issue_dispatch(self, raw_frame):
        """Dispatch the SWT motion step for a tracked frame; returns a
        pending record for finish_issued, or None on failure (re-init
        performed). Only valid while initialized."""
        pend = self.swt.track_dispatch(raw_frame)
        if pend is None:
            self._reinit()
        return pend

    def finish_issued(self, pend, fetched=None):
        """Complete a previously dispatched SWT step; returns the latest
        optimized state or None on failure (re-init performed)."""
        if self.swt is None:
            return None
        ok = self.swt.track_finish(pend, fetched=fetched)
        if not ok:
            self._reinit()
            return None
        return self.swt.latest_state

    def _reinit(self):
        """Tracking lost: reset to a fresh initializer
        (frontend_worker.cpp:71-77)."""
        self.swt = None
        self.ft.initialized = False
        self.initializer = Initializer(self.cfg, self.k)
        self.n_reinits += 1
