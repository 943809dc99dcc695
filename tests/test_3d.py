"""3D DOT — a capability beyond the reference, free from the
dimension-generic core (cone width 2 + 4*3 = 14, 4-axis DCT, 3 face
blocks). Verifies convergence, mass conservation, and the linear geodesic
of two Gaussians."""
import pytest
import numpy as np

from dotsocp.multilevel.solve import solve_dot


@pytest.mark.slow
def test_3d_transport_geodesic():
    n = 17
    ax = np.linspace(0, 1, n)
    Z, Y, X = np.meshgrid(ax, ax, ax, indexing="ij")

    def gauss(c, s=0.12):
        return np.exp(
            -((X - c[0]) ** 2 + (Y - c[1]) ** 2 + (Z - c[2]) ** 2) / (2 * s * s)
        )

    rho0 = gauss((0.3, 0.3, 0.3))
    rho0 /= rho0.mean()
    rho1 = gauss((0.7, 0.7, 0.7))
    rho1 /= rho1.mean()

    out, _, h = solve_dot(
        rho0, rho1, nt=9, level_n=2,
        opts={"tol": 1e-4, "maxit": 3000, "driver": "host"},
        method="inPALM", verbose=False,
    )
    k = h["kkt"][-1]
    assert max(k[0], k[2], k[5], k[6]) < 1e-4
    assert out["mass_ok"]
    rho = np.asarray(out["rho"])
    com = [(rho[t] * X).mean() / rho[t].mean() for t in (0, 4, 8)]
    np.testing.assert_allclose(com, [0.3, 0.5, 0.7], atol=5e-3)
