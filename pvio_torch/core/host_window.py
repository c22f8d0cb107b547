"""Host-side mutable mirror of the solver window.

Matches `pvio_tpu/core/host_window.py`: `HostWindow` with its frame slots
(`append_frame`, `drop_tail`, `_refresh_track_columns`), track columns
(`column_of`, `alloc_column`, `release_column`, `add_observation`) and
device round trips (`to_device`, `from_device`, `device_arrays`,
`apply_fetched`, `shift_after_marginalize`). The mirrors are numpy arrays
of the same dtypes as the reference's (int32 indices and flags on the
host; the port's window tensors hold them as int64).

`to_device` ships the mirrors and any extra host operands in ONE upload
(`utils/transfer.upload`), and `from_device` fetches the solver results in
ONE copy; the prior stays on the device between round trips. The upload
copies the mirrors before it returns, so the host may mutate them while
the device works on the copy.

`from_arrays` carries state across from the reference: it takes a dict of
a reference `HostWindow`'s fields as numpy values (the prior as a dict of
its fields) and builds the port's window on a device.
"""

import numpy as np
import torch

from pvio_torch.map import window as win
from pvio_torch.utils import transfer

# mirror fields shipped by to_device, in order
_UPLOAD = ("q", "p", "v", "bg", "ba", "frame_mask", "fix_mask", "inv_depth", "ref_frame",
           "track_mask", "track_flags", "quality", "plane_id", "kp", "obs_mask",
           "plane_normal", "plane_distance", "plane_mask")
_INT32 = ("track_flags", "ref_frame", "plane_id")


class HostWindow:
    def __init__(self, F_cap, T_cap, P_cap, dtype=np.float32, device="cpu"):
        self.F = F_cap
        self.T = T_cap
        self.P = P_cap
        self.dtype = dtype
        self.device = torch.device(device)
        self.q = np.tile([1.0, 0, 0, 0], (F_cap, 1)).astype(dtype)
        self.p = np.zeros((F_cap, 3), dtype)
        self.v = np.zeros((F_cap, 3), dtype)
        self.bg = np.zeros((F_cap, 3), dtype)
        self.ba = np.zeros((F_cap, 3), dtype)
        self.frame_mask = np.zeros(F_cap, bool)
        self.fix_mask = np.zeros(F_cap, bool)
        self.keyframe = np.zeros(F_cap, bool)   # FF_KEYFRAME flags (host-only)
        self.frame_id = -np.ones(F_cap, np.int64)
        self.frame_t = np.zeros(F_cap, np.float64)
        # per-frame IMU sample buffers (for re-integration at current bias)
        self.imu_ts = [None] * F_cap   # each: (n,) float64
        self.imu_w = [None] * F_cap
        self.imu_a = [None] * F_cap
        self.inv_depth = np.ones(T_cap, dtype)
        self.ref_frame = np.zeros(T_cap, np.int32)
        self.track_mask = np.zeros(T_cap, bool)
        self.track_flags = np.zeros(T_cap, np.int32)
        self.quality = np.zeros(T_cap, dtype)
        self.plane_id = -np.ones(T_cap, np.int32)
        self.track_id = -np.ones(T_cap, np.int64)   # global track id per column
        self.track_life = np.zeros(T_cap, np.int32)  # observation count (Track::life)
        self.kp = np.zeros((F_cap, T_cap, 2), dtype)
        self.obs_mask = np.zeros((F_cap, T_cap), bool)
        self.plane_normal = np.zeros((P_cap, 3), dtype)
        self.plane_normal[:, 2] = 1.0
        self.plane_distance = np.zeros(P_cap, dtype)
        self.plane_mask = np.zeros(P_cap, bool)
        self.plane_ids = -np.ones(P_cap, np.int64)   # global plane ids
        self._col_of_track = {}
        # the prior lives on the device (kept from the last round trip)
        self.prior = win.empty_prior(F_cap, self.torch_dtype, self.device)
        # host mirror of prior.valid (avoids a device fetch per keyframe)
        self.prior_valid = False

    @property
    def torch_dtype(self):
        return torch.float32 if np.dtype(self.dtype) == np.float32 else torch.float64

    @classmethod
    def from_arrays(cls, d, device="cpu"):
        """A HostWindow from a dict of a reference HostWindow's fields
        (numpy values; `imu_ts`/`imu_w`/`imu_a` lists, `_col_of_track` dict,
        `prior` a dict of MargPrior fields, `prior_valid` bool)."""
        F, T = np.asarray(d["kp"]).shape[:2]
        P = np.asarray(d["plane_mask"]).shape[0]
        hw = cls(F, T, P, np.asarray(d["q"]).dtype.type, device)
        for name, value in d.items():
            if name == "prior":
                value = win.MargPrior(*(win._tensor(f, value[f], hw.torch_dtype, hw.device)
                                        for f in win.MargPrior._fields))
            elif name in ("imu_ts", "imu_w", "imu_a"):
                value = [None if x is None else np.array(x) for x in value]
            elif name == "_col_of_track":
                value = {int(k): int(c) for k, c in value.items()}
            elif name == "prior_valid":
                value = bool(value)
            else:
                value = np.array(value)
            setattr(hw, name, value)
        return hw

    # ------------------------------------------------------------------
    # frame slots
    # ------------------------------------------------------------------
    @property
    def n_frames(self):
        return int(self.frame_mask.sum())

    def append_frame(self, frame_id, t, q, p, v, bg, ba, imu_ts, imu_w, imu_a,
                     keyframe=False):
        """Append at the first free slot (slots are kept front-packed)."""
        slot = self.n_frames
        assert slot < self.F, "window full — marginalize first"
        self.frame_mask[slot] = True
        self.frame_id[slot] = frame_id
        self.frame_t[slot] = t
        self.q[slot] = q
        self.p[slot] = p
        self.v[slot] = v
        self.bg[slot] = bg
        self.ba[slot] = ba
        self.keyframe[slot] = keyframe
        self.imu_ts[slot] = np.asarray(imu_ts, np.float64)
        self.imu_w[slot] = np.asarray(imu_w)
        self.imu_a[slot] = np.asarray(imu_a)
        self.kp[slot] = 0.0
        self.obs_mask[slot] = False
        return slot

    def drop_tail(self):
        """Erase the newest frame (non-keyframe replacement path)."""
        slot = self.n_frames - 1
        self.frame_mask[slot] = False
        self.obs_mask[slot] = False
        self.kp[slot] = 0.0
        self.imu_ts[slot] = None
        # tracks that only lived in the tail lose an observation
        self._refresh_track_columns()
        return slot

    def _refresh_track_columns(self):
        """Recompute ref_frame; release columns with < 1 obs. `track_life`
        is a monotonic observation counter and is not recomputed."""
        obs = self.obs_mask & self.frame_mask[:, None]
        cnt = obs.sum(axis=0)
        dead = self.track_mask & (cnt == 0)
        for c in np.nonzero(dead)[0]:
            self.release_column(int(c))
        alive = self.track_mask & (cnt > 0)
        self.ref_frame[alive] = np.argmax(obs[:, alive], axis=0)

    # ------------------------------------------------------------------
    # track columns
    # ------------------------------------------------------------------
    def column_of(self, track_id):
        return self._col_of_track.get(int(track_id))

    def alloc_column(self, track_id, ref_slot):
        free = np.nonzero(~self.track_mask)[0]
        if len(free) == 0:
            return None
        c = int(free[0])
        self.track_mask[c] = True
        self.track_id[c] = track_id
        self.track_flags[c] = 0
        self.inv_depth[c] = 1.0
        self.quality[c] = 0.0
        self.plane_id[c] = -1
        self.ref_frame[c] = ref_slot
        self.track_life[c] = 0
        self.kp[:, c] = 0.0
        self.obs_mask[:, c] = False
        self._col_of_track[int(track_id)] = c
        return c

    def release_column(self, c):
        tid = int(self.track_id[c])
        self._col_of_track.pop(tid, None)
        self.track_mask[c] = False
        self.track_flags[c] = 0
        self.track_id[c] = -1
        self.obs_mask[:, c] = False
        self.plane_id[c] = -1

    def add_observation(self, col, slot, kp_normalized):
        if not self.obs_mask[:, col].any():
            self.ref_frame[col] = slot
        self.kp[slot, col] = kp_normalized
        self.obs_mask[slot, col] = True
        self.track_life[col] += 1

    # ------------------------------------------------------------------
    # device round-trips
    # ------------------------------------------------------------------
    def to_device(self, extra=None):
        """The device WindowState, from ONE upload of the mirrors (empty
        deltas, bg_lin/ba_lin = bg/ba, the device-resident prior).

        `extra`: optional sequence of host operands shipped in the SAME
        upload; returns (window, extra tensors) when given."""
        dt, dev = self.torch_dtype, self.device
        ts = transfer.upload([getattr(self, n) for n in _UPLOAD] + list(extra or ()), dev, dt)
        f = dict(zip(_UPLOAD, ts[:len(_UPLOAD)]))
        w = win.WindowState(
            delta=win.empty_delta(self.F, dt, dev),
            delta_valid=torch.zeros(self.F, dtype=torch.bool, device=dev),
            bg_lin=f["bg"], ba_lin=f["ba"], prior=self.prior, **f)
        if extra is None:
            return w
        return w, tuple(ts[len(_UPLOAD):])

    def from_device(self, w: win.WindowState, extra=None):
        """Pull solver results back (states, depths, flags, quality, kp,
        planes, frame_mask) in ONE fetch; frame/track topology stays
        host-owned. `extra`: optional pytree of device values fetched in the
        SAME copy and returned as host arrays."""
        fetched, extra_h = transfer.get(transfer.Fetch((self.device_arrays(w), extra)))
        return self.apply_fetched(w, fetched, extra_h)

    @staticmethod
    def device_arrays(w: win.WindowState):
        """The device tensors a from_device(w) fetches, for a caller that
        batches them with other stages' results."""
        return (w.q, w.p, w.v, w.bg, w.ba, w.inv_depth,
                w.track_flags, w.quality, w.ref_frame,
                w.track_mask, w.kp, w.obs_mask, w.plane_id,
                w.plane_normal, w.plane_distance,
                w.plane_mask, w.frame_mask)

    def apply_fetched(self, w: win.WindowState, fetched, extra_h=None):
        """Apply pre-fetched host values of device_arrays(w) to the host
        mirrors (the second half of from_device)."""
        names = ("q", "p", "v", "bg", "ba", "inv_depth", "track_flags", "quality",
                 "ref_frame", "track_mask", "kp", "obs_mask", "plane_id", "plane_normal",
                 "plane_distance", "plane_mask", "frame_mask")
        for name, a in zip(names, fetched):
            a = np.array(a)
            setattr(self, name, a.astype(np.int32) if name in _INT32 else a)
        self.prior = w.prior
        # drop host bookkeeping for columns the device invalidated
        for c in np.nonzero(~self.track_mask & (self.track_id >= 0))[0]:
            self.release_column(int(c))
        return extra_h

    def shift_after_marginalize(self, index=0):
        """Mirror marginalize_and_remove's slot compaction for the
        host-only fields (device fields come via from_device)."""
        sl = list(range(self.F))
        sl.pop(index)
        for name in ["frame_id", "frame_t", "keyframe"]:
            a = getattr(self, name)
            setattr(self, name, np.concatenate([a[sl], np.zeros_like(a[:1])]))
        self.frame_id[-1] = -1
        for name in ["imu_ts", "imu_w", "imu_a"]:
            lst = getattr(self, name)
            setattr(self, name, [lst[i] for i in sl] + [None])
