"""Tests of the port's hand-written kernels that need a CUDA card.

They carry the `cuda` marker and skip without a card. The file imports
neither jax nor the reference, so it also runs where JAX is not
installed: `python -m pytest tests/test_torch_cuda.py --noconftest -q`.
"""

import numpy as np
import pytest
import torch


@pytest.mark.cuda
def test_shi_tomasi_kernel_matches_plain_on_card():
    """K1 against its plain version over the full image, three sizes, one
    not a multiple of the 32x16 tile. Tolerance 1e-6 of the response
    range: the kernel sums in another order in float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from pvio_torch.frontend import detect
    from pvio_torch.ops import stencil

    rng = np.random.default_rng(7)
    for H, W in [(480, 752), (240, 376), (481, 755)]:
        img = torch.as_tensor(rng.uniform(size=(H, W)), dtype=torch.float32, device="cuda")
        before = stencil.LAUNCHES
        out = stencil.shi_tomasi_response(img)
        torch.cuda.synchronize()
        ref = detect.shi_tomasi_response(img)
        assert stencil.LAUNCHES == before + 1
        err = float((out - ref).abs().max())
        assert err <= 1e-6 * float(ref.abs().max()) + 1e-9, (H, W, err)
    with pytest.raises(ValueError, match="contiguous"):
        stencil.shi_tomasi_response(img.t())
