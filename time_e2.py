#!/usr/bin/env python3
"""Time kernel E2 (the marginalization's symmetric eigen-decomposition)
beside other builds of it on one card.

    python3 time_e2.py [--baseline OTHER.cu ...] [--out FILE]

Builds `pvio_torch/csrc/sym_eig_block.cu` and every `--baseline` source
with `pvio_torch.utils.cuda_build` (one nvcc each, all started together).
A baseline is another source with the same C entry `pvio_sym_eig_block`
(A, L, V, scratch, sweeps, B, n, stream; a scratch of B * m * (m + 1)
doubles, m = n rounded up to even), for example an earlier commit's copy
of the kernel.

The inputs are chip_smoke.py's phase-2 cases (`chip_smoke.marg_cases`: the
bench window's 15x15 victim block and (F*15)-square prior, and the vmapped
chain's stack of 11 priors) and a seeded random symmetric 105x105 matrix
(the prior's size at F = 7), all float32 as the main path gives them,
upcast to float64 on the way in and its results cast back on the way out
as `ops/eigh.py` does. Each build is held against torch.linalg.eigh with
chip_smoke.py's tolerance (`eig_gap`, as its phase 2 holds E2), its
outputs are compared with the repository's build (equal bit for bit or
not), then it is timed by device time per launch from a
profiler trace (`chip_smoke.device_ms`, the yardstick of chip_smoke.py's
kernels line) in two turns: every build in order, then in reverse.

Prints one JSON line per build and case and the card's nvidia-smi line;
--out also writes them to a file. Needs one CUDA card.
"""

import argparse
import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main():
    import torch

    if not torch.cuda.is_available():
        print("time_e2: needs a CUDA card", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", action="append", default=[],
                    help="another E2 source with the same C entry (repeatable)")
    ap.add_argument("--out", help="also write the JSON lines to this file")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))

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
    for key, x in cases.items():
        L_p, _ = torch.linalg.eigh(x)
        ref = launch(libs["repo"], x)
        for name, lib in libs.items():
            L, V, sweeps = launch(lib, x)
            err, lim = cs.eig_gap(x, L, V, L_p)
            if not err <= lim:
                raise RuntimeError(f"{name} disagrees with torch.linalg.eigh on {key}: "
                                   f"{err} > {lim}")
            same = all(torch.equal(a, b) for a, b in zip((L, V, sweeps), ref))
            ms[key, name] = [dict(err=err, same_as_repo=same,
                                  sweeps=[int(s) for s in sweeps.cpu()])]
    names = list(libs)
    for turn in (names, names[::-1]):
        for name in turn:
            for key, x in cases.items():
                ms[key, name].append(cs.device_ms(lambda: launch(libs[name], x), reps=20,
                                                  warmup=2))
    smi = cs.gpu_line()
    for (key, name), (rec, *times) in ms.items():
        lines.append(json.dumps(dict(case=key, shape=list(cases[key].shape), build=name,
                                     ms=times, **rec)))
    lines.append(json.dumps(dict(gpu=smi, torch=torch.__version__)))
    print("\n".join(lines))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
