"""Unit tests for the operator core: adjointness, spectral identities,
cone-projection properties, and the q-diagonal — the test gate the reference
never had (SURVEY.md section 4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dotsocp.ops.geometry import Geometry
from dotsocp.ops import staggered as stg
from dotsocp.ops.grad import grad, grad_T
from dotsocp.ops.cone import bfd, bfd_T, proj_soc, oper_q_diag
from dotsocp.ops.poisson import make_dct_poisson, dct_matrix

GEOMS = [
    Geometry(nt=5, space=(9,)),
    Geometry(nt=5, space=(7, 9)),
    Geometry(nt=4, space=(6, 5)),
]


def _rand_staggered(geom, rng, dtype=jnp.float64):
    return stg.Staggered(
        q0=jnp.asarray(rng.standard_normal(geom.q0_shape), dtype),
        bs=tuple(
            jnp.asarray(rng.standard_normal(geom.b_shape(a)), dtype)
            for a in range(geom.ndim_space)
        ),
    )


@pytest.mark.parametrize("geom", GEOMS)
def test_grad_adjoint(geom, rng):
    """<A phi, v> == <phi, A^T v>."""
    phi = jnp.asarray(rng.standard_normal(geom.phi_shape))
    v = _rand_staggered(geom, rng)
    lhs = grad(geom, phi).dot(v)
    rhs = jnp.vdot(phi, grad_T(geom, v))
    assert np.isclose(float(lhs), float(rhs), rtol=1e-12)


@pytest.mark.parametrize("geom", GEOMS)
def test_bfd_adjoint(geom, rng):
    """<BF q, x> == <q, (BF)^T x> (the d-offset excluded: scale_d = 0)."""
    q = _rand_staggered(geom, rng)
    x = jnp.asarray(rng.standard_normal(geom.z_shape))
    s = 0.73
    lhs = jnp.vdot(bfd(geom, q, s, 0.0), x)
    rhs = q.dot(bfd_T(geom, x, s))
    assert np.isclose(float(lhs), float(rhs), rtol=1e-12)


@pytest.mark.parametrize("geom", GEOMS)
def test_bfd_d_offset(geom):
    """scale_d lands only in head/tail columns: per-cell ||d|| = sqrt(2)."""
    q = stg.zeros(geom, jnp.float64)
    z = bfd(geom, q, 1.0, 3.0)
    assert np.allclose(np.asarray(z[0]), 3.0)
    assert np.allclose(np.asarray(z[-1]), 3.0)
    assert np.allclose(np.asarray(z[1:-1]), 0.0)


@pytest.mark.parametrize("geom", GEOMS)
def test_oper_q_equals_bfd_gram_diag(geom, rng):
    """diag(I + (E/D)^2 F*B*BF) matches applying BF^T BF to basis vectors.

    Cross-check of ``oper_q.m`` against the actual stencils: for any q,
    elementwise, (BF^T BF q)_i == (diag - 1) q_i when q is a basis vector.
    We verify via random diagonal probing on the exact structure: build the
    Gram diagonal by applying bfd/bfd_T to indicator fields.
    """
    D, E = 1.3, 0.7
    diag = oper_q_diag(geom, D, E, dtype=jnp.float64)
    s = E / D
    # probe a handful of entries per block
    rs = np.random.default_rng(1)

    def gram_diag_entry(basis):
        z = bfd(geom, basis, s, 0.0)
        back = bfd_T(geom, z, s)
        return back, basis

    for trial in range(3):
        # time-staggered block
        idx = tuple(rs.integers(0, n) for n in geom.q0_shape)
        e = stg.zeros(geom, jnp.float64)
        e = e._replace(q0=e.q0.at[idx].set(1.0))
        back, _ = gram_diag_entry(e)
        assert np.isclose(float(back.q0[idx]) + 1.0, float(diag.q0[idx]), rtol=1e-12)
        # face blocks
        for a in range(geom.ndim_space):
            idx = tuple(rs.integers(0, n) for n in geom.b_shape(a))
            e = stg.zeros(geom, jnp.float64)
            bs = list(e.bs)
            bs[a] = bs[a].at[idx].set(1.0)
            e = e._replace(bs=tuple(bs))
            back, _ = gram_diag_entry(e)
            assert np.isclose(
                float(back.bs[a][idx]) + 1.0, float(diag.bs[a][idx]), rtol=1e-12
            )


def test_proj_soc_cases():
    v = jnp.array(
        [
            [2.0, 0.5, -1.0, 0.0, -3.0],   # head
            [1.0, 1.0, 1.0, 0.0, 1.0],     # tail components
            [0.0, 1.0, 1.0, 0.0, 1.0],
        ]
    )
    out = np.asarray(proj_soc(v))
    # col0: ||w||=1 <= 2 -> identity
    assert np.allclose(out[:, 0], [2.0, 1.0, 0.0])
    # col1: ||w||=sqrt2 > 0.5 -> boundary projection
    nrm = np.sqrt(2)
    c = 0.5 * (1 + 0.5 / nrm)
    assert np.allclose(out[:, 1], [c * nrm, c, c])
    # col2: ||w||=sqrt2 <= 1 = -z0 -> 0... check: z0=-1, ||w||=sqrt2 > 1 -> boundary
    c2 = 0.5 * (1 - 1.0 / nrm)
    assert np.allclose(out[:, 2], [c2 * nrm, c2, c2])
    # col3: w=0, z0=0 -> 0
    assert np.allclose(out[:, 3], 0.0)
    # col4: ||w||=sqrt2 <= 3 = -z0 -> 0
    assert np.allclose(out[:, 4], 0.0)


def test_proj_soc_idempotent_and_moreau(rng):
    v = jnp.asarray(rng.standard_normal((6, 50)))
    p = proj_soc(v)
    # idempotent
    assert np.allclose(np.asarray(proj_soc(p)), np.asarray(p), atol=1e-12)
    # in the cone
    assert np.all(np.asarray(p[0]) >= np.linalg.norm(np.asarray(p[1:]), axis=0) - 1e-12)
    # Moreau: v = proj_K(v) - proj_K(-v) for self-dual K
    m = proj_soc(-v)
    assert np.allclose(np.asarray(p - m), np.asarray(v), atol=1e-12)


def test_dct_matrix_orthogonal():
    C = dct_matrix(17, jnp.float64)
    assert np.allclose(np.asarray(C @ C.T), np.eye(17), atol=1e-12)


@pytest.mark.parametrize("geom", GEOMS)
def test_poisson_solves_normal_equations(geom, rng):
    """phi from the DCT solve satisfies D^2 A^T A phi = rhs up to the
    pinned zero mode (rhs projected off constants)."""
    D = 1.17
    solver = make_dct_poisson(geom, D=D, dtype=jnp.float64)
    rhs = jnp.asarray(rng.standard_normal(geom.phi_shape))
    rhs = rhs - rhs.mean()  # compatible rhs (A^T A annihilates constants)
    phi = solver.solve(rhs)
    lap = grad_T(geom, grad(geom, phi)) * (D * D)
    assert np.allclose(np.asarray(lap), np.asarray(rhs), atol=1e-9)


@pytest.mark.parametrize("geom", GEOMS)
def test_poisson_matches_jax_dctn(geom, rng):
    """Matmul-DCT equals the FFT-based dctn/idctn route (reference parity:
    mirt_dctn/mirt_idctn)."""
    from jax.scipy import fft as jfft

    D = 0.9
    solver = make_dct_poisson(geom, D=D, dtype=jnp.float64)
    rhs = jnp.asarray(rng.standard_normal(geom.phi_shape))
    phi = solver.solve(rhs)
    kern = 1.0 / solver.inv_kernel
    ref = jfft.idctn(
        jfft.dctn(rhs, type=2, norm="ortho") / kern, type=2, norm="ortho"
    )
    assert np.allclose(np.asarray(phi), np.asarray(ref), atol=1e-10)


def test_flat_roundtrip(rng):
    geom = Geometry(nt=4, space=(5, 6))
    st = _rand_staggered(geom, rng)
    flat = stg.to_flat(st)
    assert flat.shape == (geom.n_cells + sum(np.prod(geom.b_shape(a)) for a in range(2)),)
    back = stg.from_flat(geom, flat, dtype=jnp.float64)
    assert np.allclose(np.asarray(back.q0), np.asarray(st.q0))
    for a in range(2):
        assert np.allclose(np.asarray(back.bs[a]), np.asarray(st.bs[a]))


def test_split_dct_precision():
    """Split-f32 DCT transform (``_apply_axis_split``): f64 contraction as
    double-word f32 matmuls with chunked f64 accumulation. Accuracy is set
    by the f32 accumulation within a chunk (~sqrt(chunk) ulp), so the win
    over plain f32 (~sqrt(n) ulp) shows on long axes: measured at n=513,
    chunk=128: ~3e-7 vs ~7e-7 relative (2.5x). The refine tail builds on this
    with a measured ~4e-6 KKT floor (multilevel/solve.py refine phases)."""
    import jax

    from dotsocp.ops.poisson import (
        _apply_axis, _apply_axis_split, dct_matrix,
    )

    n = 513
    rng = np.random.default_rng(5)
    M = dct_matrix(n, jnp.float64)
    x = jnp.asarray(rng.standard_normal((n, 64)))
    ref = np.asarray(_apply_axis(M, x, 0))  # true f64 on CPU
    got = np.asarray(_apply_axis_split(M, x, 0))
    f32 = np.asarray(
        _apply_axis(M.astype(jnp.float32), x.astype(jnp.float32), 0)
    )
    scale = np.abs(ref).max()
    err_split = np.abs(got - ref).max() / scale
    err_f32 = np.abs(f32 - ref).max() / scale
    assert err_split < 5e-7, err_split
    assert err_split < err_f32 / 2, (err_split, err_f32)
    # every contraction position (incl. middle axis + non-square chunks)
    x3 = jnp.asarray(rng.standard_normal((5, n, 7)))
    for ax in (0, 1, 2):
        Ma = dct_matrix(x3.shape[ax], jnp.float64)
        r = np.asarray(_apply_axis(Ma, x3, ax))
        g = np.asarray(_apply_axis_split(Ma, x3, ax))
        np.testing.assert_allclose(g, r, rtol=0, atol=2e-6 * np.abs(r).max())


def test_neumann_ata_stencil_matches_spectrum():
    """neumann_ata_apply (the IR residual operator) is spectrally identical
    to the DCT kernel: C^T diag(eigenvalues) C x == A^T A x."""
    from dotsocp.ops.poisson import (
        _apply_axis, neumann_ata_apply, neumann_eigenvalues,
    )

    rng = np.random.default_rng(11)
    for geom in GEOMS:
        ns = (geom.nt,) + geom.space
        x = jnp.asarray(rng.standard_normal(ns))
        # spectral A^T A: transform, multiply eigenvalue sum, transform back
        kernel = np.zeros(ns)
        for ax, n in enumerate(ns):
            shape = [1] * len(ns)
            shape[ax] = n
            kernel = kernel + neumann_eigenvalues(n).reshape(shape)
        y = x
        mats = [dct_matrix(n, jnp.float64) for n in ns]
        for ax, C in enumerate(mats):
            y = _apply_axis(C, y, ax)
        y = y * jnp.asarray(kernel)
        for ax, C in enumerate(mats):
            y = _apply_axis(C.T, y, ax)
        got = neumann_ata_apply(x, tuple(float((n - 1) ** 2) for n in ns))
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(y), rtol=0,
            atol=1e-9 * float(np.abs(np.asarray(y)).max()),
        )


def test_ir_dct_precision():
    """IR f64 solve (split='ir'): f32 DCT base solve + f64 stencil-residual
    refinement reaches ~f64-grade phi with NO accuracy floor (unlike the
    double-word split path's ~2e-8*n KKT floor). Two steps suffice; one
    step already beats the split path."""
    geom = Geometry(nt=9, space=(33, 129))
    rng = np.random.default_rng(7)
    rhs = jnp.asarray(rng.standard_normal((geom.nt,) + geom.space))
    ref = make_dct_poisson(geom, dtype=jnp.float64)  # true f64 (CPU native)
    scale = 1.0 / (0.37 ** 2)  # exercise the traced use-time scale
    want = np.asarray(ref.solve(rhs, scale=scale))
    span = float(np.abs(want).max())

    ir2 = make_dct_poisson(geom, split="ir")
    got2 = np.asarray(ir2.solve(rhs, scale=scale))
    assert got2.dtype == np.float64
    err2 = np.abs(got2 - want).max() / span
    assert err2 < 1e-11, err2

    ir1 = make_dct_poisson(geom, split="ir", ir_steps=1)
    err1 = np.abs(np.asarray(ir1.solve(rhs, scale=scale)) - want).max() / span
    assert err1 < 1e-8, err1

    f32 = make_dct_poisson(geom, dtype=jnp.float32)
    errf32 = (
        np.abs(np.asarray(f32.solve(rhs.astype(jnp.float32),
                                    scale=scale)) - want).max() / span
    )
    assert err2 < errf32 * 1e-3, (err2, errf32)

    # Helmholtz branch (epsilon shifts the kernel instead of pinning)
    ref_e = make_dct_poisson(geom, epsilon=2.5, dtype=jnp.float64)
    ir_e = make_dct_poisson(geom, epsilon=2.5, split="ir")
    want_e = np.asarray(ref_e.solve(rhs))
    err_e = (np.abs(np.asarray(ir_e.solve(rhs)) - want_e).max()
             / float(np.abs(want_e).max()))
    assert err_e < 1e-11, err_e
