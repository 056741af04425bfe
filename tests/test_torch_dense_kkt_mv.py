"""The dense KKT step's refinement residual (``solver/ip.py``
``_refine_residual``) on the CPU: it adds the diagonal shift to the product
instead of forming the shifted H0, and so gives what the former expressions
(the shifted H0 formed, three batched products) gave, to the rounding of the
sums: within (k + 3) eps times the sum of the terms' magnitudes, k the terms
a sum adds.  In f32 and f64, for the solver's strided Je (a transposed view
of its column block) and a contiguous one, at ragged shapes and B = 1 and 3.
"""

import pytest
import torch

from landing_controller_tpu_torch.solver.ip import _refine_residual

torch.set_num_threads(1)


def _system(B, n, me, mi, dtype, seed=0):
    """The solver's operands: Je as the transposed view of the column block
    (make_dense_newton_step), H0, a positive shift, vectors."""
    g = torch.Generator().manual_seed(seed)

    def t(*shape):
        return torch.randn(*shape, generator=g, dtype=dtype)

    cols = t(B, n, n + me + mi)
    Je = cols.transpose(1, 2)[:, n:n + me]
    H0 = t(B, n, n)  # not symmetric, so that a transposed read shows
    delta_used, dH = torch.rand(B, generator=g, dtype=dtype) + 0.1, t(B, n).abs() + 0.5
    return dict(H0=H0, Je=Je, delta_used=delta_used, dH=dH,
                delta_c=torch.clamp(1e-6 * delta_used, min=1e-8), dz=t(B, n), dy=t(B, me),
                rhs_z=t(B, n), rhs_y=t(B, me))


def _former_expressions(H0, Je, delta_used, dH, delta_c, dz, dy, rhs_z, rhs_y):
    """The refinement's residual as solver/ip.py wrote it with the shifted H0."""
    eye = torch.eye(H0.shape[-1], dtype=H0.dtype)

    def mv(M, v):
        return (M @ v[..., None])[..., 0]

    JeT = Je.transpose(1, 2)
    Hd = H0 + (delta_used[:, None] * dH * dH)[:, :, None] * eye
    r_z = rhs_z - (mv(Hd, dz) + mv(JeT, dy))
    r_y = rhs_y - (mv(Je, dz) - delta_c[:, None] * dy)
    return r_z, r_y


SHAPES = [(1, 37, 21, 5), (3, 37, 21, 5), (3, 16, 8, 0), (2, 70, 45, 3)]


@pytest.mark.parametrize("contiguous_je", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,n,me,mi", SHAPES)
def test_plain_versions_equal_the_solver_expressions(B, n, me, mi, dtype, contiguous_je):
    s = _system(B, n, me, mi, dtype)
    if contiguous_je:
        s["Je"] = s["Je"].contiguous()
    shift = s["delta_used"][:, None] * s["dH"] * s["dH"]
    args = (s["H0"], shift, s["Je"], s["delta_c"], s["dz"], s["dy"], s["rhs_z"], s["rhs_y"])
    got_z, got_y = _refine_residual(*args)
    want = _former_expressions(**s)
    # the exact residual and the terms' magnitudes, in f64
    d = [a.double() for a in args]
    exact_z, exact_y = _refine_residual(*d)
    a = [x.abs() for x in d]
    mag_z = a[6] + (a[0] @ a[4][..., None])[..., 0] + a[1] * a[4] \
        + (a[2].transpose(1, 2) @ a[5][..., None])[..., 0]
    mag_y = a[7] + (a[2] @ a[4][..., None])[..., 0] + a[3][:, None] * a[5]
    eps = torch.finfo(dtype).eps
    for got, former, exact, mag, k in ((got_z, want[0], exact_z, mag_z, n + me + 2),
                                       (got_y, want[1], exact_y, mag_y, n + 2)):
        bound = (k + 3) * eps * mag
        assert bool(((got.double() - exact).abs() <= bound).all())
        assert bool(((former.double() - exact).abs() <= bound).all())
