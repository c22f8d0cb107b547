"""The root conftest's prebuild of the reference's native libraries.

`conftest.py::prebuild_native` builds `csrc/libpviocore.so` and
`csrc/libpvioloader.so` before any xdist worker collects, so that no worker
loads a half-written library or skips the native tests on a race. Here it
runs on a copy of the two sources: from six processes at once, each library
then loads in six fresh processes; a stale library is rebuilt and a fresh
one left alone; its g++ command lines are the reference's own loaders'.
"""

import ctypes
import importlib.util
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
N_PROCS = 6

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")


def prebuild_module():
    spec = importlib.util.spec_from_file_location("root_conftest_prebuild", ROOT / "conftest.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def csrc(tmp_path):
    for lib, src, _ in prebuild_module().LIBRARIES:
        shutil.copy2(ROOT / "csrc" / src, tmp_path / src)
    return tmp_path


def run_all(code, *args):
    """Start N_PROCS python processes running `code` together; wait for all
    and return their (exit code, stdout, stderr)."""
    procs = [subprocess.Popen([sys.executable, "-c", code, *args], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(N_PROCS)]
    return [(p.wait(timeout=240), *p.communicate()) for p in procs]


PREBUILD = """
import importlib.util, json, sys
spec = importlib.util.spec_from_file_location("root_conftest", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
print(json.dumps(mod.prebuild_native(sys.argv[2])))
"""

LOAD = """
import ctypes, sys
for path in sys.argv[1:]:
    ctypes.CDLL(path)
"""


def test_prebuild_from_six_processes_then_load_from_six(csrc):
    import json

    mod = prebuild_module()
    built = run_all(PREBUILD, str(ROOT / "conftest.py"), str(csrc))
    assert all(rc == 0 for rc, _, _ in built), built
    outcomes = [json.loads(out) for _, out, _ in built]
    libs = [lib for lib, _, _ in mod.LIBRARIES]
    # exactly one process built each library; the others found it fresh
    for lib in libs:
        assert sorted(o[lib] for o in outcomes) == ["built"] + ["fresh"] * (N_PROCS - 1), outcomes
    loaded = run_all(LOAD, *(str(csrc / lib) for lib in libs))
    assert all(rc == 0 for rc, _, _ in loaded), loaded
    assert sorted(p.name for p in csrc.iterdir()) == sorted(
        [mod.LOCK] + libs + [src for _, src, _ in mod.LIBRARIES])


def test_stale_library_rebuilt_fresh_one_untouched(csrc):
    import os

    mod = prebuild_module()
    assert set(mod.prebuild_native(csrc).values()) == {"built"}
    so, src = csrc / "libpviocore.so", csrc / "pvio_core.cpp"
    t_src = src.stat().st_mtime_ns
    os.utime(so, ns=(t_src - 10**9, t_src - 10**9))        # a second older than its source
    fresh = csrc / "libpvioloader.so"
    t_fresh = fresh.stat().st_mtime_ns
    assert mod.prebuild_native(csrc) == {"libpviocore.so": "built", "libpvioloader.so": "fresh"}
    assert so.stat().st_mtime_ns >= t_src
    assert fresh.stat().st_mtime_ns == t_fresh
    ctypes.CDLL(str(so))
    t_so = so.stat().st_mtime_ns
    assert set(mod.prebuild_native(csrc).values()) == {"fresh"}
    assert (so.stat().st_mtime_ns, fresh.stat().st_mtime_ns) == (t_so, t_fresh)


def test_prebuild_runs_the_reference_loaders_command_lines(csrc, monkeypatch):
    """The reference's `_build`s, pointed at the copy, and the prebuild run
    the same g++ command lines but for the output path (-o)."""
    from pvio_tpu.io import native_loader
    from pvio_tpu.utils import native

    calls = []

    def recorded(cmd, **kw):
        calls.append(list(cmd))
        Path(cmd[cmd.index("-o") + 1]).touch()
        return subprocess.CompletedProcess(cmd, 0, b"", b"")

    monkeypatch.setattr(subprocess, "run", recorded)
    monkeypatch.setattr(native, "_CSRC", csrc)
    monkeypatch.setattr(native, "_SO", csrc / "libpviocore.so")
    monkeypatch.setattr(native_loader, "_SO", csrc / "libpvioloader.so")
    monkeypatch.setattr(native_loader, "_SRC", csrc / "pvio_loader.cpp")
    native._build()
    native_loader._build()
    reference = calls[:]
    for lib, _, _ in prebuild_module().LIBRARIES:
        (csrc / lib).unlink()
    calls.clear()
    assert set(prebuild_module().prebuild_native(csrc).values()) == {"built"}
    assert len(calls) == len(reference) == 2

    def without_output(cmd):
        i = cmd.index("-o")
        return cmd[:i + 1] + cmd[i + 2:]

    assert [without_output(c) for c in calls] == [without_output(c) for c in reference]
    assert [c[c.index("-o") + 1] for c in reference] == [
        str(csrc / "libpviocore.so"), str(csrc / "libpvioloader.so")]
