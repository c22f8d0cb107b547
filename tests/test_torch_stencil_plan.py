"""Launch plan of kernel K1 (`pvio_torch/ops/stencil.py::launch_plan`) on
the CPU: the tiles cover the image, 480x752 fits one wave, the TMA stage
is taken exactly where TMA can load the tile, and the Python plan holds
the same tile as the CUDA source. The kernel itself runs only on a card
(`tests/test_torch_cuda.py`)."""

import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pvio_torch.frontend import detect
from pvio_torch.ops import stencil

H100_SMS = 132


def _coverage(H, W, plan):
    """How many blocks of the plan write each pixel."""
    th, tw = plan.tile
    count = np.zeros((H, W), np.int32)
    for by in range(plan.grid[1]):
        for bx in range(plan.grid[0]):
            count[by * th:(by + 1) * th, bx * tw:(bx + 1) * tw] += 1
    return count


@settings(max_examples=60, deadline=None)
@given(H=st.integers(1, 1080), W=st.integers(1, 1920))
def test_launch_plan_covers_every_pixel_once(H, W):
    plan = stencil.launch_plan(H, W, 0)
    assert (_coverage(H, W, plan) == 1).all()
    th, tw = plan.tile
    # no block lies wholly outside the image
    assert (plan.grid[0] - 1) * tw < W and (plan.grid[1] - 1) * th < H


def test_launch_plan_fits_the_main_path_in_one_wave():
    plan = stencil.launch_plan(480, 752, 0)
    assert plan.tma
    assert plan.grid[0] * plan.grid[1] <= H100_SMS, plan


@pytest.mark.parametrize("W", [1, 3, 4, 5, 130, 752, 755, 1920])
@pytest.mark.parametrize("offset", [0, 4, 8, 12, 16, 512])
def test_launch_plan_takes_tma_exactly_when_it_applies(W, offset):
    plan = stencil.launch_plan(37, W, 0x7F0000000000 + offset)
    assert plan.tma == (W % 4 == 0 and offset % 16 == 0)
    bh, bw = plan.box
    (oy, ox), (th, tw) = stencil.BOX_OFFSET, plan.tile
    # the box holds the tile and at least its 2-px halo on every side
    assert oy <= -2 and ox <= -2 and (bh, bw) == (th - 2 * oy, tw - 2 * ox)
    # cuTensorMapEncodeTiled: each box dimension <= 256, inner box bytes a
    # multiple of 16; the copy: every block's innermost start coordinate a
    # multiple of 16 B
    assert bh <= 256 and bw <= 256 and (bw * 4) % 16 == 0
    assert all(((bx * tw + ox) * 4) % 16 == 0 for bx in range(plan.grid[0]))


def test_launch_plan_tile_matches_the_cuda_source():
    src = stencil.SOURCE.read_text()
    th, tw, run = (int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
                   for name in ("TH", "TW", "RUN"))
    assert stencil.TILE == (th, tw)
    assert tw % 4 == 0 and th % run == 0
    # threads of a block: 4 columns x `run` rows each, within the 1024 limit
    assert (tw // 4) * (th // run) <= 1024


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(1, 1), (7, 130), (49, 65)])
def test_wrapper_takes_the_plain_version_on_cpu(shape, dtype):
    img = torch.as_tensor(np.random.default_rng(3).uniform(size=shape), dtype=dtype)
    before = stencil.LAUNCHES
    out = stencil.shi_tomasi_response(img)
    assert stencil.LAUNCHES == before
    assert out.dtype == dtype and out.shape == img.shape
    assert torch.equal(out, detect.shi_tomasi_response(img))


@pytest.mark.parametrize("W", [1, 2, 3, 4, 130, 752, 755])
@pytest.mark.parametrize("offset", [0, 8, 16, 24])
def test_launch_plan_at_float64_takes_tma_for_16_byte_rows(W, offset):
    """K1's float64 form (fault F7's repair): the same tile and box, TMA
    where the base is 16-B aligned and a row of W float64 values is a
    multiple of 16 B (W even); the box's rows and every block's start stay
    16-B multiples at 8 B an element."""
    plan = stencil.launch_plan(37, W, 0x7F0000000000 + offset, itemsize=8)
    assert plan.tma == (W % 2 == 0 and offset % 16 == 0)
    assert plan[:3] == stencil.launch_plan(37, W, 0)[:3]
    (oy, ox), (th, tw) = stencil.BOX_OFFSET, plan.tile
    assert (plan.box[1] * 8) % 16 == 0
    assert all(((bx * tw + ox) * 8) % 16 == 0 for bx in range(plan.grid[0]))
    assert stencil.cost(480, 752, itemsize=8)[0] == 2 * stencil.cost(480, 752)[0]


def test_k1_computes_at_the_image_dtype():
    """The wrapper launches K1's float64 entry for a float64 image and the
    float32 one for any other dtype, so at float64 the card's response is
    the plain version's function at the plain version's precision (the
    60 s float64 run on the card took the reference's outcome only with a
    float64 response, fault F7). The source exports both entries and the
    plan's element size."""
    assert stencil.compute_dtype(torch.float64) == torch.float64
    for dt in (torch.float32, torch.float16, torch.bfloat16, torch.uint8):
        assert stencil.compute_dtype(dt) == torch.float32
    src = stencil.SOURCE.read_text()
    assert re.search(r'extern "C" int pvio_shi_tomasi_f64\(const double\* img, double\* out', src)
    assert re.search(r'extern "C" int pvio_shi_tomasi\(const float\* img, float\* out', src)
    assert re.search(r"pvio_shi_tomasi_plan\(int H, int W, const void\* img, int elem", src)
    assert "CU_TENSOR_MAP_DATA_TYPE_FLOAT64" in src
