"""Build a CUDA source of the port into a shared library at first use.

Each kernel source under `pvio_torch/csrc/` exposes a plain `extern "C"`
launcher, so it compiles with `nvcc` alone, without PyTorch's headers (a
few seconds instead of minutes), and loads with `ctypes`. Libraries go to
`pvio_torch/_build/` (git-ignored), named by a hash of the source and the
flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing is built at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_ROOT = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_ROOT / "csrc"
BUILD_DIR = PACKAGE_ROOT / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc():
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: building the port's CUDA kernels "
                           "needs the CUDA toolkit")
    return found


def library_path(source):
    src = Path(source)
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:16]}.so"


def build(source):
    """Compile `source` (a path under csrc/) unless its library exists.
    Returns (library path, nvcc's output or "" when reused)."""
    return build_all([source])[Path(source)]


def build_all(sources=None):
    """Compile every given source (default: all of csrc/*.cu) whose
    library does not exist yet, one nvcc process per source, all started
    together. Returns {source: (library path, nvcc's output)}."""
    sources = [Path(s) for s in (sorted(CSRC.glob("*.cu")) if sources is None else sources)]
    results, jobs = {}, []
    try:
        for src in sources:
            out = library_path(src)
            if out.exists():
                results[src] = (out, "")
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen([find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
            jobs.append((src, out, tmp, proc))
        for src, out, tmp, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{log}")
            os.replace(tmp, out)
            results[src] = (out, log)
    finally:
        for _, _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return results


def load(source):
    """Build if needed and load the library with ctypes."""
    path, _ = build(source)
    return ctypes.CDLL(str(path))
