"""How far a hand-written kernel's output may lie from its plain version's.

Shared by :mod:`.flash_attention`, :mod:`.fused_loss` and
:mod:`.paged_attention`: the card check (``chip_smoke.py``,
``tests/test_torch_cuda.py``) holds every output of those kernels, element
by element, to the bound of :data:`KERNEL_TOLERANCE` for the output's type
(or for the type the kernel rounds its intermediates to, where that is
bf16 and the output f32):

    |got - ref| <= rtol |ref| + row_tol rms_row(ref) + floor_tol rms(ref)

``rms_row`` is taken over the last axis (one query's or key's head dim,
one token's hidden vector, one hidden unit's vocab row), so a row whose
values are small is held at its own scale; the floor covers elements
whose exact value is 0, where both sides keep f32 noise.

bf16: both sides round an intermediate (p, ds) and the output to bf16
from f32 values that differ (sums in another order, p against another
running max), about 2^-8 of each term, which adds up over a row to a few
thousandths of its rms, and one output rounding may flip (one ulp, at
most 2^-7 of the value). f32 (and the f32 lse or target logit of a bf16
call): sums in another order.
"""

from __future__ import annotations

import torch

KERNEL_TOLERANCE = {
    torch.bfloat16: (2.0 ** -7, 2.0 ** -5, 2.0 ** -10),
    torch.float32: (2.0 ** -16, 2.0 ** -16, 2.0 ** -14),
}


def kernel_error(got: torch.Tensor, ref: torch.Tensor, dtype=None) -> dict:
    """A kernel's output against its plain version's, in the bound of
    :data:`KERNEL_TOLERANCE` for ``dtype`` (default ``ref``'s type): the
    max abs error, the worst ratio of an element's error to its bound (<= 1
    passes) and the relative error norm ``|got - ref| / |ref|``."""
    rtol, row_tol, floor_tol = KERNEL_TOLERANCE[ref.dtype if dtype is None else dtype]
    g, r = got.double(), ref.double()
    err = (g - r).abs()
    sq = r.square()
    bound = (rtol * r.abs() + row_tol * sq.mean(-1, keepdim=True).sqrt()
             + floor_tol * sq.mean().sqrt())
    tiny = torch.finfo(torch.float64).tiny
    return {
        "max_abs_err": float(err.max()),
        "worst_ratio": float((err / bound.clamp_min(tiny)).max()),
        "rel_norm_err": float(err.norm() / r.norm().clamp_min(tiny)),
        "tolerance": {"rtol": rtol, "row_rms_tol": row_tol, "rms_tol": floor_tol},
    }
