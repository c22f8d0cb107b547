"""Tests of the port's hand-written kernels that need a CUDA card.

They carry the `cuda` marker and skip without a card. The file imports
neither jax nor the reference, so it also runs where JAX is not
installed: `python -m pytest tests/test_torch_cuda.py --noconftest -q`.
"""

import numpy as np
import pytest
import torch

# (H, W, storage offset in floats): chip_smoke.py's shapes, from 1x1 to one
# 24x128 tile, one tile plus a pixel each way, and a contiguous view 4 bytes
# into its storage (TMA cannot load it)
K1_CASES = [(480, 752, 0), (240, 376, 0), (481, 755, 0), (1, 1, 0), (3, 5, 0),
            (7, 130, 0), (24, 128, 0), (25, 129, 0), (1, 752, 0), (480, 752, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,offset", K1_CASES)
def test_shi_tomasi_kernel_matches_plain_on_card(H, W, offset):
    """K1 against its plain version over the full image. Tolerance 1e-6 of
    the response range plus 1e-9: the kernel sums in another order in
    float32. The load stage is TMA exactly for an aligned image whose rows
    are a multiple of 16 B."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from pvio_torch.frontend import detect
    from pvio_torch.ops import stencil

    rng = np.random.default_rng(7)
    flat = torch.as_tensor(rng.uniform(size=H * W + offset), dtype=torch.float32, device="cuda")
    img = flat[offset:].view(H, W)
    plan = stencil.launch_plan(H, W, img.data_ptr())
    assert plan.tma == (offset == 0 and W % 4 == 0)
    assert stencil.kernel_plan(H, W, img.data_ptr()) == plan
    before = stencil.LAUNCHES
    out = stencil.shi_tomasi_response(img)
    torch.cuda.synchronize()
    ref = detect.shi_tomasi_response(img)
    assert stencil.LAUNCHES == before + 1
    err = float((out - ref).abs().max())
    assert err <= 1e-6 * float(ref.abs().max()) + 1e-9, (H, W, offset, err)
    with pytest.raises(ValueError, match="contiguous"):
        stencil.shi_tomasi_response(torch.zeros(8, 6, device="cuda").t())
