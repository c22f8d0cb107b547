#!/usr/bin/env python3
"""Time kernel K1 (Shi-Tomasi response) at other tile shapes on one card.

    python3 sweep_k1_tiles.py [--baseline OTHER.cu] [--out FILE]

For each entry of TILES (tile rows, tile columns, output rows per thread)
writes a copy of `pvio_torch/csrc/shi_tomasi.cu` with those values of its
`TH`, `TW` and `RUN` constants into `pvio_torch/_build/k1_sweep/`, and
builds every copy with `pvio_torch.utils.cuda_build` (one nvcc each, all
started together). The first entry is the kernel's own design.
`--baseline` adds another source with the same C entry `pvio_shi_tomasi`
(for example an earlier commit's kernel).

The input is the main path's: level 0 of the bench scene's first frame
after CLAHE (chip_smoke.bench_inputs, DeviceKernels.preprocess), 480x752.
Each build is held against the plain PyTorch version on it and on a copy
4 bytes into its storage (both load stages) with chip_smoke.py's
tolerance, then timed by device time per launch from a profiler trace
(chip_smoke.device_ms, the yardstick of chip_smoke.py's kernels line) in
two turns: every build in order, then in reverse. Last comes the launch
floor, the device time of a 1-element zero_().

Prints one JSON line per build and the card's nvidia-smi line; --out also
writes them to a file. Needs one CUDA card.
"""

import argparse
import ctypes
import json
import re
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H, W = 480, 752
TILES = [(24, 128, 2), (48, 64, 2), (48, 64, 3), (48, 64, 1), (40, 72, 2), (60, 48, 2)]


def variant_source(text, th, tw, run):
    """The kernel's source with its tile constants set to (th, tw, run)."""
    for name, value in (("TH", th), ("TW", tw), ("RUN", run)):
        text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                          text)
        if n != 1:
            raise RuntimeError(f"shi_tomasi.cu: no single `constexpr int {name}` to set")
    return text


def main():
    import torch

    if not torch.cuda.is_available():
        print("sweep_k1_tiles: needs a CUDA card", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="another K1 source with the same C entry")
    ap.add_argument("--out", help="also write the JSON lines to this file")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))

    import chip_smoke as cs
    from pvio_torch.core.kernels import DeviceKernels
    from pvio_torch.frontend import detect
    from pvio_torch.io.config import Config
    from pvio_torch.ops import stencil
    from pvio_torch.utils import cuda_build

    src_dir = cuda_build.BUILD_DIR / "k1_sweep"
    src_dir.mkdir(parents=True, exist_ok=True)
    sources = {}    # build name -> (source, grid or None)
    for th, tw, run in TILES:
        path = src_dir / f"shi_tomasi_{th}x{tw}_run{run}.cu"
        path.write_text(variant_source(stencil.SOURCE.read_text(), th, tw, run))
        sources[f"{th}x{tw}/run{run}"] = (path, [-(-W // tw), -(-H // th)])
    if args.baseline:
        sources["baseline"] = (Path(args.baseline), None)
    built = cuda_build.build_all([p for p, _ in sources.values()])
    fns = {}
    for key, (path, _) in sources.items():
        lib, log = built[Path(path)]
        fn = ctypes.CDLL(str(lib)).pvio_shi_tomasi
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[key] = fn
        print(f"{key}: {[ln.strip() for ln in log.splitlines() if 'registers' in ln]}",
              flush=True)

    dev = torch.device("cuda")
    cfg = Config()
    cfg.dtype = "float32"
    _, host = cs.bench_inputs(cfg, 0)
    img = DeviceKernels(cfg).preprocess(host["images"][0])[0].contiguous()
    if tuple(img.shape) != (H, W):
        raise RuntimeError(f"bench frame is {tuple(img.shape)}, not {(H, W)}")
    flat = torch.empty(H * W + 1, device=dev)
    flat[1:] = img.flatten()
    stream = torch.cuda.current_stream().cuda_stream

    def launch(fn, x):
        out = torch.empty_like(x)
        err = fn(x.data_ptr(), out.data_ptr(), H, W, stream)
        if err != 0:
            raise RuntimeError(f"K1 launch failed: {err}")
        return out

    errs = {}
    for key, fn in fns.items():
        errs[key] = []
        for x in (img, flat[1:].view(H, W)):
            out = launch(fn, x)
            torch.cuda.synchronize()
            ref = detect.shi_tomasi_response(x)
            err = float((out - ref).abs().max())
            lim = cs.K1_REL_TOL * float(ref.abs().max()) + cs.K1_ABS_TOL
            if not err <= lim:
                raise RuntimeError(f"{key} disagrees with the plain version: {err} > {lim}")
            errs[key].append(err)

    times = {key: [] for key in fns}
    for order in (list(fns), list(fns)[::-1]):
        for key in order:
            times[key].append(cs.device_ms(lambda: launch(fns[key], img)))
    one = torch.empty(1, device=dev)
    floor_ms = cs.device_ms(lambda: one.zero_())
    smi = cs.gpu_line()
    lines = [json.dumps(dict(build=key, device_ms=statistics.mean(t), turns_ms=t,
                             max_abs_err=errs[key], grid=sources[key][1], shape=[H, W],
                             card=smi))
             for key, t in times.items()]
    lines.append(json.dumps(dict(build="launch floor: 1-element zero_()", device_ms=floor_ms,
                                 card=smi)))
    for ln in lines:
        print(ln)
    print(smi)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines + [smi]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
