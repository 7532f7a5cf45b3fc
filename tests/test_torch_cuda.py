"""The port's CUDA kernels against their plain versions, on a card.

Marker ``cuda``: these skip on a host without a CUDA device. On a card
(where JAX is not installed, so the suite's ``conftest.py`` cannot load):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Small ragged shapes, to reach the kernels' edge masking; ``chip_smoke.py``
holds the kernels against the plain versions at the serving shapes.
Tolerances: f32 rtol/atol 1e-5 (the same products summed in another
order); bf16 2e-2 (outputs round once to bf16, 2^-8 relative, and another
summation order can land on the neighbouring bf16 value).
"""

import pytest
import torch

from fpsg_torch.nn import fused_stack as tfs
from fpsg_torch.ops.pool import maxpool2x2, maxpool2x2_plain

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_kernels_match_plain_on_card(dt):
    """Each CUDA kernel against its plain version on the card, at small
    ragged shapes (the serving shapes are ``chip_smoke.py``'s)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    tdt = DTYPES[dt]
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen).to(dtype).cuda()

    x = rnd(2, 10, 14, 24, dtype=tdt)
    y, code = maxpool2x2(x, return_index=True)
    ry, rcode = maxpool2x2_plain(x)
    assert torch.equal(y, ry) and torch.equal(code, rcode)

    tol = dict(rtol=1e-5, atol=1e-5) if dt == "f32" else \
        dict(rtol=2e-2, atol=2e-2)
    yc = rnd(2, 3, 3, 150)
    d, wd = rnd(2, 3, 3 * 40, 3, dtype=tdt), rnd(2, 3, 3, 150, dtype=tdt)
    torch.testing.assert_close(tfs.fused_l1_layer(d, wd, yc, 40),
                               tfs.fused_l1_plain(d, wd, yc, 40), **tol)
    yp, k, b = rnd(2, 3, 300, 139, dtype=tdt), rnd(2, 3, 139), rnd(2, 3, 139)
    w = rnd(2, 3, 139, 131, dtype=tdt) / 12
    torch.testing.assert_close(tfs.fused_mid_layer(yp, k, b, w),
                               tfs.fused_mid_plain(yp, k, b, w), **tol)
    w4, bias = rnd(2, 3, 139, 3, dtype=tdt) / 12, rnd(2, 3, 3)
    torch.testing.assert_close(tfs.fused_out_layer(yp, k, b, w4, bias),
                               tfs.fused_out_plain(yp, k, b, w4, bias), **tol)
