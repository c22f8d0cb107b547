"""Adaptive multi-sequence host serving: N COMPLETE PVIO engines -- each
with its own initializer <-> sliding-window state machine, keyframe gate,
plane map and re-init path -- driven by ONE host loop that merges their
per-frame device synchronization points.

Matches `pvio_tpu/parallel/serving.py`: `MultiSequenceServer`. The
reference pays one round trip per `jax.device_get` call, so its loop makes
one combined fetch for the whole fleet's frontend step and one for its
motion step. In the port every engine's `dispatch_frame` and
`issue_dispatch` already start their own packed asynchronous copy
(`transfer.Fetch`), so the fleet's "one fetch" per phase is the order of
the harvest: every engine dispatches first, then the loop harvests the
copies together in one `transfer.get`, which waits once on the engines'
common stream, for the newest copy: the host waits twice per tick for the
whole fleet (once for the frontend, once for the motion step). A tick in
which an engine initializes or solves a keyframe adds that engine's own
waits (the initializer's fetches; the keyframe step's fetch and the plane
extractor's).

Keyframe solves run per engine exactly when that engine's gate fires, so
keyframe schedules, initialization timing and failure recovery diverge
freely across sequences, unlike `parallel/multi_seq.py`'s fixed-cadence
vmapped chain. Per-sequence outputs equal solo sequential runs bit for bit:
each engine runs the same steps on the same inputs in the same order; only
the host's blocking pattern changes.
"""

from typing import List, Optional

from pvio_torch.api import PVIO, OutputPose
from pvio_torch.core import swt as swt_mod
from pvio_torch.io.config import Config
from pvio_torch.utils import transfer
from pvio_torch.utils.forensics import bus as forensics


class MultiSequenceServer:
    """Serve N sequences through N independent PVIO engines with shared
    per-tick harvests of their device copies.

    Usage:
        srv = MultiSequenceServer([cfg0, cfg1, ...])   # device="cpu" opts out of CUDA
        srv.track_gyroscope(i, t, x, y, z)      # queue sensor data
        srv.track_accelerometer(i, t, x, y, z)
        srv.track_camera(i, t, image)           # queue a frame
        srv.pump()                              # process everything ready
        srv.get_trajectory(i)

    Sensor feeds only queue; `pump()` advances every engine whose next
    frame has its IMU span complete, harvesting the fleet's copies
    together. `track_camera` calls `pump()` itself by default
    (`auto_pump=True`); a caller interleaving many sequences should pass
    auto_pump=False and pump once per round for maximal sharing.

    `ticks` records, per tick, (engines in the tick, fleet harvests,
    host waits): two harvests when any engine issued a motion step, else
    one; the waits are `transfer.WAITS` counted over the tick (each harvest
    is one on the card, none on the CPU).
    """

    def __init__(self, configs: List[Config], auto_pump: bool = True, device=None):
        self.vios = [PVIO(cfg, device=device) for cfg in configs]
        for v in self.vios:
            v.core.defer_frames = True
        self.auto_pump = auto_pump
        self.ticks = []

    @property
    def n_sequences(self) -> int:
        return len(self.vios)

    # -- per-sequence sensor entry points (pvio.h:135-148 facade, with a
    # leading sequence index) --
    def track_gyroscope(self, i, t, x, y, z) -> Optional[OutputPose]:
        return self.vios[i].track_gyroscope(t, x, y, z)

    def track_accelerometer(self, i, t, x, y, z) -> Optional[OutputPose]:
        return self.vios[i].track_accelerometer(t, x, y, z)

    def track_camera(self, i, t, image) -> Optional[OutputPose]:
        out = self.vios[i].track_camera(t, image)
        if self.auto_pump:
            self.pump()
        return out

    # -- the shared host loop --
    def pump(self) -> int:
        """Process every queued frame whose IMU span is complete, across
        all engines, sharing the per-tick harvests fleet-wide. Returns the
        number of frames processed."""
        processed = 0
        while True:
            batch = []
            for i, v in enumerate(self.vios):
                got = v.core.poll_ready_frame()
                if got is not None:
                    batch.append((i, got))
            if not batch:
                return processed
            self._tick(batch)
            processed += len(batch)

    def _tick(self, batch):
        harvests, waits0 = 0, transfer.WAITS
        # Phase A: dispatch every engine's fused frontend step (async)
        handles = []
        for i, (fid, t, image, ts, ws, accs) in batch:
            core = self.vios[i].core
            h = core.feature_tracker.dispatch_frame(fid, t, image, ts, ws, accs)
            core._last_frame_t = t
            handles.append((i, h))
        # Phase B: ONE harvest of the whole fleet's frontend copies
        with forensics.timer("serving_frontend_fetch"):
            vals = transfer.get(
                [self.vios[i].core.feature_tracker.handle_arrays(h) for i, h in handles])
        harvests += 1
        # Phase C: host association + estimator dispatch per engine
        pends = []
        for (i, h), fv in zip(handles, vals):
            core = self.vios[i].core
            with forensics.timer("feature_tracker_time"):
                rf = core.feature_tracker.finish_frame(h, fetched=fv)
            fw = core.frontend
            if fw.initialized:
                pend = fw.issue_dispatch(rf)
                if pend is not None:
                    pends.append((i, pend))
            else:
                # initializer path (per engine; synchronous by design: it
                # runs rarely and its two-view search is host-driven)
                state = fw.issue_frame(rf)
                if state is not None:
                    core._emit_output(state)
        # Phase D: ONE harvest of the whole fleet's motion-step copies
        if pends:
            with forensics.timer("serving_pnp_fetch"):
                vals2 = transfer.get([swt_mod.pend_fetch_arrays(p) for _, p in pends])
            harvests += 1
            # Phase E: keyframe/window bookkeeping per engine (keyframe
            # solves fire independently, only where each gate says so)
            for (i, pend), fv in zip(pends, vals2):
                core = self.vios[i].core
                state = core.frontend.finish_issued(pend, fetched=fv)
                if state is not None:
                    core._emit_output(state)
        self.ticks.append((len(batch), harvests, transfer.WAITS - waits0))

    # -- per-sequence queries --
    def initialized(self, i) -> bool:
        return self.vios[i].initialized

    def get_trajectory(self, i):
        return list(self.vios[i].core.outputs)

    def get_planes(self, i):
        return self.vios[i].get_planes()

    def get_latest_state(self, i):
        return self.vios[i].get_latest_state()
