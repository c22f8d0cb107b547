"""TUM-format trajectory writer and reader.

The port's own copy of `pvio_tpu/io/tum_writer.py`: `TumTrajectoryWriter`
(reference pvio-pc output_writer.h:26-51: `t px py pz qx qy qz qw`, flushed
per pose) and `load_tum`.
"""

import numpy as np


class TumTrajectoryWriter:
    def __init__(self, path):
        self.f = open(path, "w")
        self.n_written = 0

    def write_pose(self, t, q_wxyz, p):
        w, x, y, z = np.asarray(q_wxyz, float)
        px, py, pz = np.asarray(p, float)
        self.f.write(f"{t} {px} {py} {pz} {x} {y} {z} {w}\n")
        self.f.flush()  # per-pose flush (output_writer.h:49)
        self.n_written += 1

    def close(self):
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def load_tum(path):
    """Read a TUM trajectory file -> (t (N,), q (N, 4) wxyz, p (N, 3))."""
    data = np.loadtxt(path)
    if data.ndim == 1:
        data = data[None]
    t = data[:, 0]
    p = data[:, 1:4]
    q = np.concatenate([data[:, 7:8], data[:, 4:7]], axis=-1)
    return t, q, p
