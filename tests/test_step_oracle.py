"""End-to-end step oracle: one full inPALM iteration composed from the
independent C++ golden kernels + scipy's DCT must match the jitted XLA step
bit-for-f64-roundoff over several chained iterations. This validates the
*composition* (step order, scalings, sign conventions), not just the
individual operators."""
import numpy as np
import jax.numpy as jnp
import pytest
from scipy.fft import dctn, idctn

from dotsocp.algorithms.core import LevelConfig
from dotsocp.algorithms.variants import InPALMKernels
from dotsocp.models.examples import get_example_2d
from dotsocp.multilevel.level import initial_scaling, initialize
from dotsocp.ops.poisson import neumann_eigenvalues

native = pytest.importorskip("dotsocp.native")


def _np_poisson_solver(geom, D):
    ns = (geom.nt,) + geom.space
    kernel = np.zeros(ns)
    for ax, n in enumerate(ns):
        shape = [1] * len(ns)
        shape[ax] = n
        kernel = kernel + neumann_eigenvalues(n).reshape(shape)
    kernel.flat[0] = 1.0
    kernel = D * D * kernel

    def solve(rhs):
        return idctn(dctn(rhs, type=2, norm="ortho") / kernel, type=2,
                     norm="ortho")

    return solve


def _np_grad(geom, phi):
    ht = geom.ht
    q0 = (phi[1:] - phi[:-1]) / ht
    by = (phi[:, 1:, :] - phi[:, :-1, :]) * (geom.space[0] - 1)
    bx = (phi[:, :, 1:] - phi[:, :, :-1]) * (geom.space[1] - 1)
    return q0, by, bx


def _np_grad_T(geom, q0, by, bx):
    nt = geom.nt
    ny, nx = geom.space
    out = (np.pad(q0, ((1, 0), (0, 0), (0, 0)))
           - np.pad(q0, ((0, 1), (0, 0), (0, 0)))) * (nt - 1)
    out += (np.pad(by, ((0, 0), (1, 0), (0, 0)))
            - np.pad(by, ((0, 0), (0, 1), (0, 0)))) * (ny - 1)
    out += (np.pad(bx, ((0, 0), (0, 0), (1, 0)))
            - np.pad(bx, ((0, 0), (0, 0), (0, 1)))) * (nx - 1)
    return out


def test_full_step_matches_native_oracle():
    rho0, rho1 = get_example_2d("example2", 17, 17)
    nt = 7
    lv = initialize(rho0, rho1, nt, dtype=jnp.float64)
    initial_scaling(lv, scaling=True)
    cfg = LevelConfig(geom=lv.geom, D=lv.D, E=lv.E, tau=1.9,
                      dtype=jnp.float64)
    k = InPALMKernels(cfg)
    s = k.prep(lv.as_dict(), sigma=1.0)
    geom = k.geom
    ny, nx = geom.space

    # numpy-side state
    phi = np.asarray(s.phi)
    q0, by, bx = (np.asarray(s.q.q0), np.asarray(s.q.bs[0]),
                  np.asarray(s.q.bs[1]))
    z = np.asarray(s.z)
    a0, aby, abx = (np.asarray(s.alpha.q0), np.asarray(s.alpha.bs[0]),
                    np.asarray(s.alpha.bs[1]))
    beta = np.asarray(s.beta)
    c = np.asarray(s.c)
    solve = _np_poisson_solver(geom, cfg.D)
    diag_q0 = np.asarray(s.diag_q_inv.q0)
    diag_by = np.asarray(s.diag_q_inv.bs[0])
    diag_bx = np.asarray(s.diag_q_inv.bs[1])
    scale_bf = cfg.E / cfg.D
    scale_d = cfg.E / float(np.asarray(s.dScale))
    tau = cfg.tau
    # z2 is no longer carried in SolverState (carry_z2=False default);
    # rebuild the cached gather from q exactly as the kernel does
    z2 = native.bfd2d(q0, by, bx, nt, ny, nx, scale_bf, scale_d)

    for _ in range(3):
        # phi-step
        rhs = cfg.D * _np_grad_T(geom, q0 - a0, by - aby, bx - abx) + c
        phi = solve(rhs)
        # z-step (native cone projection)
        z = native.proj_soc(z2 - beta)
        # q-step (native adjoint gather)
        g0, gby, gbx = _np_grad(geom, phi)
        tq0, tby, tbx = cfg.D * g0, cfg.D * gby, cfg.D * gbx
        q2_0, q2_by, q2_bx = native.bfd_conj2d(z + beta, nt, ny, nx, scale_bf)
        q0 = (tq0 + a0 + q2_0) * diag_q0
        by = (tby + aby + q2_by) * diag_by
        bx = (tbx + abx + q2_bx) * diag_bx
        # multiplier step (native gather)
        z2 = native.bfd2d(q0, by, bx, nt, ny, nx, scale_bf, scale_d)
        a0 = a0 + tau * (tq0 - q0)
        aby = aby + tau * (tby - by)
        abx = abx + tau * (tbx - bx)
        beta = beta + tau * (z - z2)

    # jitted steps
    for _ in range(3):
        s = k.run_one(s)

    np.testing.assert_allclose(np.asarray(s.phi), phi, atol=1e-10)
    np.testing.assert_allclose(np.asarray(s.q.q0), q0, atol=1e-10)
    np.testing.assert_allclose(np.asarray(s.q.bs[1]), bx, atol=1e-10)
    np.testing.assert_allclose(np.asarray(s.z), z, atol=1e-10)
    np.testing.assert_allclose(np.asarray(s.alpha.q0), a0, atol=1e-10)
    np.testing.assert_allclose(np.asarray(s.beta), beta, atol=1e-10)
