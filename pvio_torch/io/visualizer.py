"""Offline forensics dashboard and live view, headless.

The port's copy of `pvio_tpu/io/visualizer.py`: `HistoryRecorder`,
`render_feature_overlay`, `render_dashboard` (with `_plot_trajectory` and
`_plot_3d`), `_sparkline` and `LiveVisualizer`, host numpy + matplotlib
(Agg, imported inside the functions that draw). The same pixels as the
reference's from the same painter and history; the default titles name
this package.

The reference app renders a live NanoVis window (pvio-pc/src/main.cpp:
87-470): tracked-feature overlays, FPS / input-output-lag / BA-time
graphs, IMU bias plots, and a 3D view of landmarks, plane patches and
camera frusta. Here the same observability is (a) a per-frame
`HistoryRecorder` sampling the forensics bus and (b) a matplotlib
dashboard rendered to PNG at the end of a run (`render_dashboard`).
Panels mirror main.cpp:

  * top-down (x, y) trajectory + landmark cloud + plane normals
    (main.cpp:353-470's 3D view, flattened),
  * side (x, z) profile,
  * stage timings: feature tracker / BA solve / marginalization
    (main.cpp:163-167 graphs the same forensics slots),
  * rates and lag (core.cpp:166-189 measurements),
  * IMU gyro/accel bias evolution (main.cpp bias plots).

They read the slots that the port's host loop fills:
`feature_tracker_painter` (`core/feature_tracker.py`) and
`sliding_window_{landmark_points,keyframe_poses,plane_states}`
(`core/swt.py`).
"""

import numpy as np

from pvio_torch.utils.forensics import bus as default_bus


class HistoryRecorder:
    """Samples scalar forensics slots once per camera frame so the
    end-of-run dashboard can graph them over time."""

    SCALARS = (
        "camera_input_rate",
        "camera_real_rate",
        "input_output_lag",
        "feature_tracker_time",
        "bundle_adjustor_solve_time",
        "bundle_adjustor_marginalization_time",
        "sliding_window_landmarks",
        "sliding_window_planes",
    )
    VECTORS = ("imu_bias_gyroscope", "imu_bias_accelerometer")

    def __init__(self, bus=None):
        self.bus = bus or default_bus
        self.t = []
        self.scalars = {k: [] for k in self.SCALARS}
        self.vectors = {k: [] for k in self.VECTORS}

    def sample(self, t):
        self.t.append(float(t))
        for k in self.SCALARS:
            v = self.bus.get(k)
            self.scalars[k].append(float(v) if v is not None else np.nan)
        for k in self.VECTORS:
            v = self.bus.get(k)
            self.vectors[k].append(
                np.asarray(v, np.float64) if v is not None
                else np.full(3, np.nan)
            )


def render_feature_overlay(path, painter=None, bus=None):
    """Draw the tracked-feature overlay the reference GUI paints live
    (ForensicsPainter, forensics.h:30-38; main.cpp:33-85 draws keypoints
    and flow segments): grayscale frame + tracked keypoints (green, with
    prev->cur flow lines) + fresh detections (blue). `painter` defaults
    to the bus's latest `feature_tracker_painter` snapshot."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if painter is None:
        painter = (bus or default_bus).get("feature_tracker_painter")
    if painter is None:
        raise ValueError("no feature_tracker_painter snapshot available")

    img = np.asarray(painter["image"], np.float64)
    kp = np.asarray(painter["kp"])
    mask = np.asarray(painter["mask"], bool)
    tracked = np.asarray(painter["tracked"], bool)
    prev_kp = painter.get("prev_kp")

    h, w = img.shape
    fig, ax = plt.subplots(figsize=(w / 96, h / 96), dpi=96)
    ax.imshow(img, cmap="gray", interpolation="nearest")
    if prev_kp is not None:
        pk = np.asarray(prev_kp)
        for i in np.nonzero(mask & tracked)[0]:
            ax.plot([pk[i, 0], kp[i, 0]], [pk[i, 1], kp[i, 1]],
                    "-", lw=0.8, color="#fb8f44", alpha=0.9)
    t_idx = mask & tracked
    d_idx = mask & ~tracked
    if t_idx.any():
        ax.plot(kp[t_idx, 0], kp[t_idx, 1], "o", ms=3, mew=0.8,
                mfc="none", color="#2da44e", label=f"tracked ({t_idx.sum()})")
    if d_idx.any():
        ax.plot(kp[d_idx, 0], kp[d_idx, 1], "s", ms=3, mew=0.8,
                mfc="none", color="#218bff", label=f"new ({d_idx.sum()})")
    ax.legend(loc="lower right", fontsize=7)
    ax.set_title(f"frame {painter['frame_id']}  t={painter['t']:.3f}s",
                 fontsize=8)
    ax.set_axis_off()
    fig.tight_layout(pad=0.1)
    fig.savefig(path, dpi=96)
    plt.close(fig)
    return path


def _plot_trajectory(ax, traj, landmarks, planes, axes=(0, 1), labels="xy"):
    if traj is not None and len(traj):
        p = np.asarray([pose[2] for pose in traj], np.float64)
        ax.plot(p[:, axes[0]], p[:, axes[1]], "-", lw=1.2, color="#1f6feb",
                label="trajectory")
        ax.plot(p[-1, axes[0]], p[-1, axes[1]], "o", ms=5, color="#1f6feb")
    if landmarks is not None and len(landmarks):
        x = np.asarray(landmarks, np.float64)
        ax.scatter(x[:, axes[0]], x[:, axes[1]], s=2, alpha=0.4,
                   color="#57606a", label=f"landmarks ({len(x)})")
    if planes:
        for n, d in planes:
            # draw the plane's anchor point (closest point to origin) and
            # its normal direction projected into this view
            c = np.asarray(n, np.float64) * float(d)
            ax.annotate(
                "", xy=(c[axes[0]] + 0.3 * n[axes[0]],
                        c[axes[1]] + 0.3 * n[axes[1]]),
                xytext=(c[axes[0]], c[axes[1]]),
                arrowprops=dict(arrowstyle="->", color="#bf3989"),
            )
    ax.set_xlabel(labels[0] + " [m]")
    ax.set_ylabel(labels[1] + " [m]")
    ax.set_aspect("equal", adjustable="datalim")
    ax.legend(loc="best", fontsize=7)


def _plot_3d(ax, trajectory, keyframe_poses, landmarks, planes,
             fov_tan=(0.8, 0.52), frustum_depth=0.35):
    """3D panel: landmark cloud + camera frusta of the window keyframes +
    plane anchor normals + trajectory (the reference's NanoVis 3D view,
    main.cpp:353-470, with frusta drawn per keyframe)."""
    from pvio_torch.geometry import nplie

    if landmarks is not None and len(landmarks):
        x = np.asarray(landmarks, np.float64)
        ax.scatter(x[:, 0], x[:, 1], x[:, 2], s=2, alpha=0.35,
                   color="#57606a")
    if trajectory is not None and len(trajectory):
        p = np.asarray([pose[2] for pose in trajectory], np.float64)
        ax.plot(p[:, 0], p[:, 1], p[:, 2], "-", lw=1.0, color="#1f6feb")
    tx, ty = fov_tan
    corners = np.array([[-tx, -ty, 1.0], [tx, -ty, 1.0],
                        [tx, ty, 1.0], [-tx, ty, 1.0]]) * frustum_depth
    for (t, q, p) in (keyframe_poses or []):
        R = nplie.quat_to_mat(np.asarray(q, np.float64))
        c = np.asarray(p, np.float64)
        pts = c[None, :] + corners @ R.T
        for k in range(4):
            a, b = pts[k], pts[(k + 1) % 4]
            ax.plot(*zip(c, pts[k]), lw=0.6, color="#2da44e")
            ax.plot(*zip(a, b), lw=0.6, color="#2da44e")
    for n, d in (planes or []):
        n = np.asarray(n, np.float64)
        c = n * float(d)
        ax.plot(*zip(c, c + 0.4 * n), lw=1.6, color="#bf3989")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    ax.set_title("3D map: landmarks / frusta / planes")


def render_dashboard(path, trajectory=None, history: HistoryRecorder = None,
                     bus=None, title="pvio_torch forensics"):
    """Render the end-of-run dashboard PNG. Returns the path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    bus = bus or default_bus
    landmarks = bus.get("sliding_window_landmark_points")
    planes = bus.get("sliding_window_plane_states")
    kf_poses = bus.get("sliding_window_keyframe_poses")

    fig = plt.figure(figsize=(15, 9))
    axs = np.empty((2, 3), object)
    for r in range(2):
        for c in range(3):
            if (r, c) == (0, 1):
                axs[r, c] = fig.add_subplot(2, 3, r * 3 + c + 1,
                                            projection="3d")
            else:
                axs[r, c] = fig.add_subplot(2, 3, r * 3 + c + 1)
    fig.suptitle(title)

    _plot_trajectory(axs[0, 0], trajectory, landmarks, planes,
                     axes=(0, 1), labels="xy")
    axs[0, 0].set_title("top-down view")
    _plot_3d(axs[0, 1], trajectory, kf_poses, landmarks, planes)

    if history is not None and history.t:
        t = np.asarray(history.t) - history.t[0]
        ax = axs[0, 2]
        for key, label in (
            ("feature_tracker_time", "feature tracker"),
            ("bundle_adjustor_solve_time", "BA solve"),
            ("bundle_adjustor_marginalization_time", "marginalization"),
        ):
            y = np.asarray(history.scalars[key]) * 1e3
            ax.plot(t, y, lw=1.0, label=label)
        ax.set_title("stage timings")
        ax.set_xlabel("t [s]")
        ax.set_ylabel("ms (rolling avg)")
        ax.legend(fontsize=7)

        ax = axs[1, 0]
        for key, label in (
            ("camera_input_rate", "input fps"),
            ("camera_real_rate", "real fps"),
            ("sliding_window_landmarks", "landmarks"),
            ("sliding_window_planes", "planes"),
        ):
            ax.plot(t, history.scalars[key], lw=1.0, label=label)
        ax.plot(t, np.asarray(history.scalars["input_output_lag"]) * 1e3,
                lw=1.0, label="lag [ms]")
        ax.set_title("rates / counts")
        ax.set_xlabel("t [s]")
        ax.legend(fontsize=7)

        for col, (key, name, scale) in enumerate((
            ("imu_bias_gyroscope", "gyro bias [rad/s]", 1.0),
            ("imu_bias_accelerometer", "accel bias [m/s²]", 1.0),
        )):
            ax = axs[1, 1 + col]
            b = np.asarray(history.vectors[key])  # (N, 3)
            if b.size:
                for i, comp in enumerate("xyz"):
                    ax.plot(t, scale * b[:, i], lw=1.0, label=comp)
            ax.set_title(name)
            ax.set_xlabel("t [s]")
            ax.legend(fontsize=7)
    else:
        for ax in (axs[0, 2], axs[1, 0], axs[1, 1], axs[1, 2]):
            ax.axis("off")

    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


# ---------------------------------------------------------------------------
# live view
# ---------------------------------------------------------------------------

_SPARK = "▁▂▃▄▅▆▇█"


def _sparkline(values, width=24):
    v = np.asarray([x for x in values if np.isfinite(x)][-width:], np.float64)
    if v.size == 0:
        return " " * width
    lo, hi = float(v.min()), float(v.max())
    span = (hi - lo) or 1.0
    idx = ((v - lo) / span * (len(_SPARK) - 1)).astype(int)
    return "".join(_SPARK[i] for i in idx).rjust(width)


_LIVE_HTML = """<!doctype html><html><head>
<meta http-equiv="refresh" content="1">
<title>pvio_torch live</title>
<style>body{{background:#0d1117;color:#c9d1d9;font-family:monospace}}
img{{max-width:100%;border:1px solid #30363d;margin:4px 0}}</style></head>
<body><h3>pvio_torch live &mdash; frame {frame} &nbsp; t={t:.2f}s &nbsp;
{fps:.1f} fps &nbsp; lag {lag:.0f} ms &nbsp; BA {ba:.1f} ms &nbsp;
landmarks {lm} &nbsp; planes {pl}</h3>
<img src="overlay.png?v={frame}"><img src="dashboard.png?v={frame}">
</body></html>
"""


class LiveVisualizer:
    """Live view of a running pipeline — the role of the reference's
    NanoVis window (pvio-pc/src/main.cpp:264-470): tracked-feature
    overlay, 3D landmarks/planes/frusta, and rolling FPS / lag / BA-time
    graphs, refreshed WHILE the run progresses.

    Two sinks, both headless-friendly:
      * html mode: writes `<dir>/live.html` (auto-refreshing) plus
        `overlay.png` / `dashboard.png`, re-rendered every `every`
        frames — open the file in any browser for a live dashboard;
      * terminal mode: one ANSI status line with unicode sparklines of
        fps / lag / BA time, rewritten in place at frame rate.
    """

    def __init__(self, directory=None, every=10, terminal=False, bus=None,
                 get_trajectory=None):
        import os

        self.bus = bus or default_bus
        self.history = HistoryRecorder(self.bus)
        self.every = max(int(every), 1)
        self.dir = directory
        self.terminal = terminal
        self.get_trajectory = get_trajectory
        self.n = 0
        if directory is not None:
            os.makedirs(directory, exist_ok=True)

    def frame(self, t):
        """Call once per camera frame."""
        self.history.sample(t)
        self.n += 1
        if self.terminal:
            self._print_status()
        if self.dir is not None and self.n % self.every == 0:
            self.render()

    # -- sinks ---------------------------------------------------------
    def _latest(self, key, default=np.nan):
        v = self.history.scalars[key]
        return v[-1] if v and np.isfinite(v[-1]) else default

    def _print_status(self):
        import sys

        h = self.history
        fps = self._latest("camera_real_rate", 0.0)
        lag = self._latest("input_output_lag", 0.0) * 1e3
        ba = self._latest("bundle_adjustor_solve_time", 0.0) * 1e3
        line = (f"\r\x1b[2Kf{self.n:05d} t={h.t[-1]:8.2f}s "
                f"fps {fps:5.1f} {_sparkline(h.scalars['camera_real_rate'])} "
                f"lag {lag:5.0f}ms "
                f"{_sparkline([x * 1e3 for x in h.scalars['input_output_lag']])} "
                f"BA {ba:5.1f}ms "
                f"{_sparkline([x * 1e3 for x in h.scalars['bundle_adjustor_solve_time']])} "
                f"lm {int(self._latest('sliding_window_landmarks', 0)):4d} "
                f"pl {int(self._latest('sliding_window_planes', 0)):2d}")
        sys.stderr.write(line)
        sys.stderr.flush()

    def render(self):
        """Re-render the live artifacts now (also called automatically
        every `every` frames)."""
        import os

        traj = self.get_trajectory() if self.get_trajectory else None
        try:
            render_feature_overlay(os.path.join(self.dir, "overlay.png"),
                                   bus=self.bus)
        except ValueError:
            pass
        # interactive 3D map (reference NanoVis 3D view, main.cpp:264-470)
        from pvio_torch.io.viewer3d import render_view3d

        render_view3d(os.path.join(self.dir, "view3d.html"),
                      bus=self.bus, trajectory=traj, live=True)
        render_dashboard(os.path.join(self.dir, "dashboard.png"),
                         trajectory=traj, history=self.history, bus=self.bus,
                         title="pvio_torch live")
        html = _LIVE_HTML.format(
            frame=self.n, t=self.history.t[-1] if self.history.t else 0.0,
            fps=self._latest("camera_real_rate", 0.0),
            lag=self._latest("input_output_lag", 0.0) * 1e3,
            ba=self._latest("bundle_adjustor_solve_time", 0.0) * 1e3,
            lm=int(self._latest("sliding_window_landmarks", 0)),
            pl=int(self._latest("sliding_window_planes", 0)))
        tmp = os.path.join(self.dir, ".live.html.tmp")
        with open(tmp, "w") as f:
            f.write(html)
        os.replace(tmp, os.path.join(self.dir, "live.html"))
