#!/usr/bin/env python3
"""Time kernel E2 (the marginalization's symmetric eigen-decomposition)
beside other builds of it on one card.

    python3 time_e2.py [--baseline OTHER.cu ...] [--out FILE]

Builds `pvio_torch/csrc/sym_eig_block.cu` and every `--baseline` source
with `pvio_torch.utils.cuda_build` (one nvcc each, all started together).
A baseline is another source with the same C entry `pvio_sym_eig_block`
(A, L, V, scratch, sweeps, B, n, stream; a scratch of B * m * (m + 1)
doubles, m = n rounded up to even, which the one-block design of the
earlier kernel needs and the current one ignores), for example an earlier
commit's copy of the kernel exported with
`git show <commit>:pvio_torch/csrc/sym_eig_block.cu > OLD.cu`. A build
skips the cases above its own `pvio_sym_eig_block_max_n()`.

The inputs are chip_smoke.py's phase-2 cases (`chip_smoke.marg_cases`: the
bench window's 15x15 victim block and (F*15)-square prior, the vmapped
chain's stack of 11 priors and a 240x240 prior-like matrix, 16 frame
slots) and a seeded random symmetric 105x105 matrix (the prior's size at
F = 7), all float32 as the main path gives them,
upcast to float64 on the way in and its results cast back on the way out
as `ops/eigh.py` does. Each build is held against torch.linalg.eigh with
chip_smoke.py's tolerance (`eig_gap`, as its phase 2 holds E2), its
outputs are compared with the repository's build (equal bit for bit or
not), then it is timed by device time per launch from a
profiler trace (`chip_smoke.device_ms`, the yardstick of chip_smoke.py's
kernels line) in two turns: every build in order, then in reverse.

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

    python3 time_e2.py --facade-check [--frames 50]

With --phases it also builds a copy of the repository's source with
PVIO_E2_PROFILE defined (into pvio_torch/_build/) and prints, per case and
per CTA of the first matrix (its warp in the small form), the SM cycles
thread 0 spends in each phase of one launch (the kernel's PROF marks) per
round (per warp round for the inner sweep's two), and the card's SM clock.

Prints one JSON line per build and case (with the repository build's
sweeps, its CPU model's, `eigh_op.jacobi_model`, and how many matrices of
that size the card runs at once), torch.linalg.eigh's device time per case,
and the card's nvidia-smi line; --out also writes them to a file. Needs one
CUDA card.
"""

import argparse
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
            if A.shape[-1] < 5:             # the 4x4 DLTs: E1's, unchanged
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


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", action="append", default=[],
                    help="another E2 source with the same C entry (repeatable)")
    ap.add_argument("--out", help="also write the JSON lines to this file")
    ap.add_argument("--facade-check", action="store_true",
                    help="the CPU check of E2's algorithm on the float32 facade (no card)")
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--phases", action="store_true",
                    help="also print the repository build's cycles per phase")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    if args.facade_check:
        lines = facade_check(args.frames)
        print("\n".join(lines))
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text("\n".join(lines) + "\n")
        return 0
    if not torch.cuda.is_available():
        print("time_e2: needs a CUDA card", file=sys.stderr)
        return 2

    import chip_smoke as cs
    from pvio_torch.core.kernels import DeviceKernels
    from pvio_torch.io.config import Config
    from pvio_torch.ops import eigh as eigh_op
    from pvio_torch.utils import cuda_build

    dev = torch.device("cuda")
    sources = {"repo": eigh_op.BLOCK_SOURCE}
    for path in args.baseline:
        sources[f"baseline {Path(path).name}"] = Path(path)
    built = cuda_build.build_all(list(sources.values()))
    libs = {}
    for name, src in sources.items():
        lib = ctypes.CDLL(str(built[Path(src)][0]))
        lib.pvio_sym_eig_block.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                                                   ctypes.c_void_p]
        lib.pvio_sym_eig_block.restype = ctypes.c_int
        libs[name] = lib
    max_n = {name: lib.pvio_sym_eig_block_max_n() for name, lib in libs.items()}

    def launch(lib, A):
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

    cfg = Config()
    cfg.dtype = "float32"
    cfg.enable_plane_constraint = True
    kern = DeviceKernels(cfg)
    w, host = cs.bench_inputs(cfg, cs.N_FRAMES)
    cases = cs.marg_cases(kern, cs.to_device(w, dev), host)
    g = torch.Generator(device="cpu").manual_seed(648)
    r = torch.rand(105, 105, generator=g, dtype=torch.float64) * 2.0 - 1.0
    cases["random 105x105"] = ((r + r.T) / 2.0).to(dev, torch.float32)

    lines, ms = [], {}
    runs = {key: [name for name in libs if x.shape[-1] <= max_n[name]]
            for key, x in cases.items()}
    for key, x in cases.items():
        L_p, _ = torch.linalg.eigh(x)
        ref = launch(libs["repo"], x)
        n = x.shape[-1]
        model = [eigh_op.jacobi_model(a)[2] for a in x.double().cpu().reshape(-1, n, n)]
        clusters = libs["repo"].pvio_sym_eig_block_max_clusters(n)
        for name in runs[key]:
            lib = libs[name]
            L, V, sweeps = launch(lib, x)
            err, lim = cs.eig_gap(x, L, V, L_p)
            if not err <= lim:
                raise RuntimeError(f"{name} disagrees with torch.linalg.eigh on {key}: "
                                   f"{err} > {lim}")
            same = all(torch.equal(a, b) for a, b in zip((L, V, sweeps), ref))
            rec = dict(err=err, same_as_repo=same, sweeps=[int(s) for s in sweeps.cpu()])
            if name == "repo":
                rec.update(model_sweeps=model, max_clusters=clusters)
            ms[key, name] = [rec]
    names = list(libs)
    for turn in (names, names[::-1]):
        for name in turn:
            for key, x in cases.items():
                if name in runs[key]:
                    ms[key, name].append(cs.device_ms(lambda: launch(libs[name], x), reps=20,
                                                      warmup=2))
    eigh_ms = {key: cs.device_ms(lambda: torch.linalg.eigh(x), reps=10, warmup=2)
               for key, x in cases.items()}
    smi = cs.gpu_line()
    for (key, name), (rec, *times) in ms.items():
        lines.append(json.dumps(dict(case=key, shape=list(cases[key].shape), build=name,
                                     ms=times, **rec)))
    lines.append(json.dumps(dict(eigh_ms=eigh_ms)))
    if args.phases:
        lines += phase_lines(cases, launch, dev)
    lines.append(json.dumps(dict(gpu=smi, torch=torch.__version__)))
    print("\n".join(lines))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
