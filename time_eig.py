#!/usr/bin/env python3
"""Time the eigen-decomposition kernels beside other builds of them on one
card: E2 (the marginalization's n x n, `pvio_torch/csrc/sym_eig_block.cu`)
or, with --e1, E1 (the triangulation's 4x4, `pvio_torch/csrc/sym_eig.cu`).

    python3 time_eig.py [--e1] [--baseline OTHER.cu ...] [--phases] [--out FILE]
    python3 time_eig.py --trace-check [--traces 30] [--out FILE]
    python3 time_eig.py --facade-check [--frames 50] [--out FILE]

Builds the repository's source and every `--baseline` source with
`pvio_torch.utils.cuda_build` (one nvcc each, all started together; each
build's register and spill lines of `-Xptxas -v` are printed). A baseline
is another copy of the kernel, for example an earlier commit's, exported
with `git show <commit>:pvio_torch/csrc/sym_eig_block.cu > OLD.cu`.

- E2: a baseline has the same C entry `pvio_sym_eig_block` (A, L, V,
  scratch, sweeps, B, n, stream; a scratch of B * m * (m + 1) doubles, m
  = n rounded up to even, which the one-block design of the earlier
  kernel needs and the current one ignores) and skips the cases above its
  own `pvio_sym_eig_block_max_n()`. The cases are chip_smoke.py's phase-2
  ones (`chip_smoke.marg_cases`: the bench window's 15x15 victim block and
  (F*15)-square prior, the vmapped chain's stack of 11 priors and a
  240x240 prior-like matrix, 16 frame slots) and a seeded random symmetric
  105x105 matrix (the prior's size at F = 7), float32 as the main path
  gives them, cast to float64 on the way in and back on the way out as
  `ops/eigh.py` does.
- E1: the repository's build runs as `ops/eigh.py` calls it, one launch
  reading and writing the float32 input. A baseline whose library lacks
  `pvio_sym_eig_abi` has the float64-only entry of the earlier
  one-thread-per-matrix kernel (A, L, V, sweeps, B, stream) and is timed
  with the casts its wrapper made (float32 to float64 in, both outputs
  back). The cases are chip_smoke.py's phase-2 E1 ones
  (`chip_smoke.eig_cases`: the bench window's 256 DLT normal matrices and
  the vmapped chain's stack of MS_B x 256).

Each build is held against torch.linalg.eigh with chip_smoke.py's
tolerance (`eig_gap`), compared with the repository's build (L, V and the
sweeps equal bit for bit or not), its sweeps against the CPU model's
(`eigh_op.jacobi_model`; {kernel - model: matrices}), then timed by
device time per call from a profiler trace (`chip_smoke.device_ms`, the
yardstick of chip_smoke.py's kernels line) in two turns: every build in
order, then in reverse; with each call's device time and kernels by
kernel name, torch.linalg.eigh's time and the launch floor (a 1-element
zero_()).

With --phases (E2) it also builds a copy of the repository's source with
PVIO_E2_PROFILE defined (into pvio_torch/_build/) and prints, per case and
per CTA of the first matrix (its warp in the small form), the SM cycles
thread 0 spends in each phase of one launch (the kernel's PROF marks) per
round (per warp round for the inner sweep's two), and the card's SM clock.

With --trace-check it counts the kernels torch.profiler reports
(`chip_smoke.profile_calls`): TRACES traces of 20 calls of E1 on 256
float32 matrices and of 60 of the launch floor, each after a
torch.linalg.eigh and a CPU model solve, as a card test runs them,
unpadded and padded as chip_smoke.trace_kernels pads them; first, then
after the CPU model has run on 2,816 matrices (the pause after which the
card test's traces fell short). Per stage, padding and function it
prints the histograms of the calls' kernels seen, of other kernels and
of the pad kernels seen before and after the calls.

With --facade-check it needs no card: it runs the float32 PVIO facade on
the CPU over the first FRAMES frames of the blob stream of
tests/test_torch_cuda.py::test_facade_on_card_matches_cpu (planes off,
the pipeline tests' small configuration: a 105-square prior) three times,
the marginalization's eigen-decompositions by torch.linalg.eigh (the
plain run, what that test's CPU side runs), by E2's algorithm
(`eigh_op.jacobi_model`, float64, as the card runs it) and by the earlier
one-block kernel's (`jacobi_model(..., one_block=True)`), and prints each
Jacobi run against the plain one as that test compares the card with the
CPU (`chip_smoke.facade_gap`: the first decision flip, the largest |dp|
before it and over all poses) and against each other. About 2 minutes.

Prints JSON lines and, last, the card's nvidia-smi line; --out also
writes them to a file. Every mode but --facade-check needs one CUDA card.
"""

import argparse
import collections
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def facade_check(frames):
    """The CPU check of --facade-check; returns its JSON lines."""
    import chip_smoke as cs
    from pvio_torch.ops import eigh as eigh_op
    from tests.test_torch_cuda import SMALL, _blob_stream

    scene, images = _blob_stream()
    real = eigh_op.eigh

    def jacobi(one_block):
        def solve(A):
            if A.shape[-1] < 5:             # the 4x4 DLTs: eigh, as the plain run
                return real(A)
            L, V, _ = eigh_op.jacobi_model(A, one_block=one_block)
            return L.to(A.dtype), V.to(A.dtype)
        return solve

    runs = {}
    for name, solve in (("eigh", real), ("E2 blocked", jacobi(False)),
                        ("E2 one-block", jacobi(True))):
        eigh_op.eigh = solve
        try:
            runs[name] = cs.run_facade(cs.facade_config(**SMALL), scene, images, device="cpu",
                                       n_frames=frames)
        finally:
            eigh_op.eigh = real
    lines = []
    for a, b in (("E2 blocked", "eigh"), ("E2 one-block", "eigh"),
                 ("E2 blocked", "E2 one-block")):
        flip, before, over = cs.facade_gap(runs[a], runs[b], scene)
        lines.append(json.dumps(dict(
            run=a, against=b, frames=frames, init_frame=[runs[a]["init_fi"], runs[b]["init_fi"]],
            keyframes=[runs[a]["keyframes"], runs[b]["keyframes"]],
            first_flip=None if flip is None else flip[0], flip=None if flip is None else flip[1],
            dp_before_flip_m=before, dp_m=over,
            ate_m=[cs.facade_ate(runs[k]["traj"], scene) for k in (a, b)])))
    return lines


PHASES = {0: "load, first test", 1: "pair block out", 2: "inner sweep",
          3: "block back, Q^T to peers", 4: "row mix", 5: "cluster wait (Q^T)",
          6: "column mix", 7: "sweep's test, wait for the slowest CTA",
          8: "A's rows to the next CTAs", 9: "ranks, output",
          10: "warp round: rotations", 11: "warp round: 2x2 blocks"}


def phase_lines(cases, launch, dev):
    """The --phases lines: one launch of each case through a profiling
    build; cycles per phase, and per round of the sweeps it took."""
    import torch

    import chip_smoke as cs
    from pvio_torch.ops import eigh as eigh_op
    from pvio_torch.utils import cuda_build

    src = cuda_build.BUILD_DIR / "sym_eig_block_profile.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text("#define PVIO_E2_PROFILE\n" + eigh_op.BLOCK_SOURCE.read_text())
    lib = ctypes.CDLL(str(cuda_build.build(src)[0]))
    lib.pvio_sym_eig_block.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                                               ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * 128)()
    warp_n, tile = lib.pvio_sym_eig_block_warp_n(), lib.pvio_sym_eig_block_tile()
    lines = []
    for key, x in cases.items():
        n = x.shape[-1]
        launch(lib, x)
        torch.cuda.synchronize()
        lib.pvio_sym_eig_block_profile(buf)          # zero after the warm-up
        _, _, sweeps = launch(lib, x)
        torch.cuda.synchronize()
        if lib.pvio_sym_eig_block_profile(buf) != 0:
            raise RuntimeError("reading E2's phase counters failed")
        sw = int(sweeps.reshape(-1)[0])
        ctas = 1
        if n > warp_n:   # a sweep's first round: 29 warp rounds, then 15 each
            nb = -(-n // tile)
            nb += nb % 2
            ctas, rounds, warp_rounds = nb // 2, sw * (nb - 1), sw * (29 + (nb - 2) * 15)
        else:
            rounds = warp_rounds = sw * (16 if n <= 16 else 32) - sw
        per_cta = []
        for c in range(ctas):
            cyc = {PHASES[i]: int(buf[16 * c + i]) for i in range(16) if buf[16 * c + i]}
            per_cta.append({k: round(v / (warp_rounds if "warp round" in k else max(rounds, 1)),
                                     1) for k, v in cyc.items()})
        lines.append(json.dumps(dict(case=key, sweeps=sw, rounds=rounds, warp_rounds=warp_rounds,
                                     cycles_per_round_by_cta=per_cta)))
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                             "--format=csv,noheader"], capture_output=True, text=True)
    lines.append(json.dumps(dict(sm_clock=clocks.stdout.strip(), gpu=cs.gpu_line())))
    return lines


def kernel_ms(fn, reps=20, warmup=2):
    """{kernel name: [device ms per call, kernels per call]} of fn() from a
    profiler trace of `reps` calls (`chip_smoke.trace_kernels`)."""
    import chip_smoke as cs

    out = {}
    for name, us in cs.trace_kernels(fn, reps, warmup):
        ms, k = out.get(name[:80], (0.0, 0.0))
        out[name[:80]] = [ms + us / reps / 1e3, k + 1 / reps]
    return out


def time_builds(cases, names, launch, reps, runs=lambda key, name: True):
    """Both timing modes' loop over `cases` ({key: matrices}) and the
    builds `names` ("repo" first); launch(name, x) returns (L, V, sweeps)
    in x's dtype. Returns the JSON lines: one per build and case, then
    torch.linalg.eigh's time per case and the launch floor."""
    import torch

    import chip_smoke as cs
    from pvio_torch.ops import eigh as eigh_op

    recs = {}
    for key, x in cases.items():
        n = x.shape[-1]
        L_p, _ = torch.linalg.eigh(x)
        ref = [t.clone() for t in launch("repo", x)]
        model = [eigh_op.jacobi_model(a)[2] for a in x.double().cpu().reshape(-1, n, n)]
        for name in names:
            if not runs(key, name):
                continue
            L, V, sweeps = launch(name, x)
            err, lim = cs.eig_gap(x, L, V, L_p)
            if not err <= lim:
                raise RuntimeError(f"{name} disagrees with torch.linalg.eigh on {key}: "
                                   f"{err} > {lim}")
            sw = sweeps.reshape(-1).tolist()
            recs[key, name] = dict(
                err=err, same_as_repo=all(torch.equal(a, b) for a, b in zip((L, V, sweeps), ref)),
                sweeps=dict(sorted(collections.Counter(sw).items())),
                sweeps_minus_model=dict(sorted(collections.Counter(
                    s - m for s, m in zip(sw, model)).items())),
                kernels=kernel_ms(lambda: launch(name, x), reps),
                ms=[])
    for turn in (names, names[::-1]):
        for name in turn:
            for key, x in cases.items():
                if (key, name) in recs:
                    recs[key, name]["ms"].append(cs.device_ms(lambda: launch(name, x), reps=reps,
                                                              warmup=2))
    one = torch.zeros(1, device=next(iter(cases.values())).device)
    lines = [json.dumps(dict(case=key, shape=list(cases[key].shape), build=name, **rec))
             for (key, name), rec in recs.items()]
    lines.append(json.dumps(dict(
        eigh_ms={key: cs.device_ms(lambda: torch.linalg.eigh(x), reps=10, warmup=2)
                 for key, x in cases.items()},
        launch_floor_ms=cs.device_ms(lambda: one.zero_()))))
    return lines


def e2_mode(sources, built, cases, dev, phases):
    """E2's builds (the repository's first) on E2's cases; JSON lines."""
    import torch

    libs = {}
    for name in sources:
        lib = ctypes.CDLL(str(built[name][0]))
        lib.pvio_sym_eig_block.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                                                   ctypes.c_void_p]
        lib.pvio_sym_eig_block.restype = ctypes.c_int
        libs[name] = lib
    max_n = {name: lib.pvio_sym_eig_block_max_n() for name, lib in libs.items()}

    def launch_lib(lib, A):
        x = A.to(torch.float64).contiguous()
        n = x.shape[-1]
        m, B = n + n % 2, x.numel() // (n * n)
        L = torch.empty(x.shape[:-1], dtype=torch.float64, device=dev)
        V = torch.empty_like(x)
        vt = torch.empty(B * m * (m + 1), dtype=torch.float64, device=dev)
        sweeps = torch.empty(B, dtype=torch.int32, device=dev)
        err = lib.pvio_sym_eig_block(x.data_ptr(), L.data_ptr(), V.data_ptr(), vt.data_ptr(),
                                     sweeps.data_ptr(), B, n,
                                     torch._C._cuda_getCurrentRawStream(dev.index or 0))
        if err != 0:
            raise RuntimeError(f"E2 launch failed: CUDA error {err}")
        return L.to(A.dtype), V.to(A.dtype), sweeps

    lines = time_builds(cases, list(libs), lambda name, x: launch_lib(libs[name], x), reps=20,
                        runs=lambda key, name: cases[key].shape[-1] <= max_n[name])
    lines.append(json.dumps(dict(max_clusters={
        key: libs["repo"].pvio_sym_eig_block_max_clusters(x.shape[-1])
        for key, x in cases.items()})))
    if phases:
        lines += phase_lines(cases, launch_lib, dev)
    return lines


def e1_mode(sources, built, cases, dev):
    """E1's builds (the repository's first, through ops/eigh.py) on E1's
    cases; JSON lines."""
    import torch

    from pvio_torch.ops import eigh as eigh_op

    libs = {}
    for name in sources:
        lib = ctypes.CDLL(str(built[name][0]))
        typed = hasattr(lib, "pvio_sym_eig_abi")          # the entry with the element size
        lib.pvio_sym_eig.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * (2 if typed else 1) \
            + [ctypes.c_void_p]
        lib.pvio_sym_eig.restype = ctypes.c_int
        libs[name] = (lib, typed)

    def launch(name, A):
        if name == "repo":
            L, V = eigh_op.eigh(A)
            return L, V, eigh_op.LAST_SWEEPS
        lib, typed = libs[name]
        x = A.contiguous() if typed else A.to(torch.float64).contiguous()
        B = x.numel() // 16
        L = torch.empty(x.shape[:-1], dtype=x.dtype, device=dev)
        V = torch.empty_like(x)
        sweeps = torch.empty(B, dtype=torch.int32, device=dev)
        stream = torch._C._cuda_getCurrentRawStream(dev.index or 0)
        size = (x.element_size(),) if typed else ()
        err = lib.pvio_sym_eig(x.data_ptr(), L.data_ptr(), V.data_ptr(), sweeps.data_ptr(), B,
                               *size, stream)
        if err != 0:
            raise RuntimeError(f"E1 launch failed ({name}): CUDA error {err}")
        return L.to(A.dtype), V.to(A.dtype), sweeps

    return time_builds(cases, list(libs), launch, reps=60)


def trace_check(dev, traces):
    """The --trace-check lines."""
    import time

    import torch

    import chip_smoke as cs
    from pvio_torch.ops import eigh as eigh_op

    A = torch.as_tensor(cs.dlt_normals(256), dtype=torch.float32, device=dev)
    one = torch.zeros(1, device=dev)
    fns = {"E1 256": (lambda: eigh_op.eigh(A), "sym_eig_kernel", 20),
           "zero_": (lambda: one.zero_(), "FillFunctor", 60)}
    lines = []
    t0, pause = time.perf_counter(), None
    for stage in ("first", "after the CPU model on 2,816 matrices"):
        if stage != "first":
            # the card test's pause before its traces went short
            B = torch.as_tensor(cs.dlt_normals(2816))
            t1 = time.perf_counter()
            for a in B:
                eigh_op.jacobi_model(a)
            pause = time.perf_counter() - t1
        for pad in (False, True):
            for key, (fn, kernel, reps) in fns.items():
                seen, pads, other = (collections.Counter() for _ in range(3))
                for _ in range(traces):
                    # between traces what a card test does between its calls
                    torch.linalg.eigh(A)
                    eigh_op.jacobi_model(A[2].double().cpu())
                    calls, before, after = cs.profile_calls(fn, reps, warmup=2, pad=pad)
                    n = sum(kernel in name for name, _ in calls)
                    seen[n] += 1
                    other[len(calls) - n] += 1
                    pads[f"{len(before)} before, {len(after)} after"] += 1
                lines.append(json.dumps(dict(
                    stage=stage, s=time.perf_counter() - t0, pause_s=pause, pad=pad, fn=key,
                    traces=traces, calls=reps, calls_seen=dict(seen), other_kernels=dict(other),
                    pad_kernels_seen=dict(pads))))
    return lines


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--e1", action="store_true",
                    help="time kernel E1 (4x4) instead of E2; --baseline then names E1 sources")
    ap.add_argument("--baseline", action="append", default=[],
                    help="another source of the kernel with its C entry (repeatable)")
    ap.add_argument("--out", help="also write the JSON lines to this file")
    ap.add_argument("--facade-check", action="store_true",
                    help="the CPU check of E2's algorithm on the float32 facade (no card)")
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--phases", action="store_true",
                    help="also print E2's repository build's cycles per phase")
    ap.add_argument("--trace-check", action="store_true",
                    help="count the kernels the profiler reports in traces of E1 and zero_()")
    ap.add_argument("--traces", type=int, default=30)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    if args.facade_check:
        lines = facade_check(args.frames)
    elif not torch.cuda.is_available():
        print("time_eig: needs a CUDA card", file=sys.stderr)
        return 2
    else:
        import chip_smoke as cs
        from pvio_torch.core.kernels import DeviceKernels
        from pvio_torch.io.config import Config
        from pvio_torch.ops import eigh as eigh_op
        from pvio_torch.utils import cuda_build

        dev = torch.device("cuda")
        if args.trace_check:
            lines = trace_check(dev, args.traces)
        else:
            sources = {"repo": eigh_op.SOURCE if args.e1 else eigh_op.BLOCK_SOURCE}
            for path in args.baseline:
                sources[f"baseline {Path(path).name}"] = Path(path)
            built = cuda_build.build_all(list(sources.values()))
            lines = [json.dumps(dict(build=name, ptxas=[
                ln.strip() for ln in built[src][1].splitlines()
                if "registers" in ln or "spill" in ln])) for name, src in sources.items()]
            built = {name: built[src] for name, src in sources.items()}
            cfg = Config()
            cfg.dtype = "float32"
            cfg.enable_plane_constraint = True
            kern = DeviceKernels(cfg)
            w, host = cs.bench_inputs(cfg, cs.N_FRAMES)
            if args.e1:
                cases = cs.eig_cases(kern, cs.to_device(w, dev))
                lines += e1_mode(sources, built, cases, dev)
            else:
                cases = cs.marg_cases(kern, cs.to_device(w, dev), host)
                g = torch.Generator(device="cpu").manual_seed(648)
                r = torch.rand(105, 105, generator=g, dtype=torch.float64) * 2.0 - 1.0
                cases["random 105x105"] = ((r + r.T) / 2.0).to(dev, torch.float32)
                lines += e2_mode(sources, built, cases, dev, args.phases)
        lines.append(json.dumps(dict(gpu=cs.gpu_line(), torch=torch.__version__)))
    print("\n".join(lines))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
