"""Build the reference's native libraries once, before any test collects.

`pvio_tpu/utils/native.py` and `pvio_tpu/io/native_loader.py` build
`csrc/libpviocore.so` and `csrc/libpvioloader.so` with g++ at first use,
writing straight onto the final path, and `tests/test_native.py` asks for
the library while it is collected. Under `pytest -n N` every worker collects
at once on a tree without the (git-ignored) libraries, so a worker could load
a half-written library or see g++ fail on a file another worker is writing,
and skip tests that would pass. This file brings both libraries up to date in
`pytest_configure` (run by the xdist controller before it starts its workers,
and again by each worker), under an exclusive lock on `csrc/.native.lock`,
with the reference's own staleness rule and command lines, each library
written to a temporary file in `csrc/` and renamed onto its name. The
reference's loaders then find a fresh library and build nothing.

It imports neither `pvio_tpu` nor `jax` nor `torch`, and selects, skips or
hides no test: where g++ or a library is missing it builds nothing and says
so on one line, and the reference's tests skip with their own message.
"""

import fcntl
import os
import subprocess
import sys
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
LOCK = ".native.lock"
# (library, source, link flags): pvio_tpu/utils/native.py::_build and
# pvio_tpu/io/native_loader.py::_build
LIBRARIES = (("libpviocore.so", "pvio_core.cpp", ()),
             ("libpvioloader.so", "pvio_loader.cpp", ("-lpng", "-lz", "-lpthread")))


def prebuild_native(csrc=CSRC):
    """Bring each library of LIBRARIES in `csrc` up to date: build it when
    it is missing or older than its source, into a temporary file that
    then replaces it, all under an exclusive lock on `csrc/LOCK`. Returns
    {library: "fresh" | "built" | the reason it was not built}."""
    csrc = Path(csrc)
    done = {}
    with open(csrc / LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for lib, src, link in LIBRARIES:
            so = csrc / lib
            if so.exists() and so.stat().st_mtime >= (csrc / src).stat().st_mtime:
                done[lib] = "fresh"
                continue
            tmp = csrc / f"{so.stem}.{os.getpid()}.tmp.so"
            try:
                subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                                "-o", str(tmp), str(csrc / src), *link],
                               check=True, capture_output=True, text=True)
                os.replace(tmp, so)
                done[lib] = "built"
            except subprocess.CalledProcessError as e:      # a header or a library missing
                done[lib] = (e.stderr.strip().splitlines() or [str(e)])[-1]
            except OSError as e:                            # no g++
                done[lib] = str(e)
            finally:
                tmp.unlink(missing_ok=True)
    return done


def pytest_configure(config):
    failed = {lib: why for lib, why in prebuild_native().items() if why not in ("fresh", "built")}
    if failed and not hasattr(config, "workerinput"):
        print("conftest: csrc/ native libraries not built, the reference's native tests will "
              "skip: " + "; ".join(f"{lib}: {why}" for lib, why in failed.items()),
              file=sys.stderr)
