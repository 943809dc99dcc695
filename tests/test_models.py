"""Problem-generator layer: shapes, normalization, barriers, weights."""
import numpy as np
import pytest

from dotsocp.models import examples as ex
from dotsocp.models import wdot2d as w2


def test_1d_examples_normalized():
    for prob in ("gaussian", "box"):
        r0, r1 = ex.get_example_1d(prob, 129)
        assert r0.shape == r1.shape == (129,)
        np.testing.assert_allclose(r0.mean(), 1.0, rtol=1e-12)
        np.testing.assert_allclose(r1.mean(), 1.0, rtol=1e-12)
        assert (r0 >= 0).all() and (r1 >= 0).all()


def test_1d_lower_bound():
    r0, _ = ex.get_example_1d("gaussian", 65, lower_bound=0.1)
    assert r0.min() >= 0.1 / 1.1 - 1e-12
    np.testing.assert_allclose(r0.mean(), 1.0, rtol=1e-12)


@pytest.mark.parametrize(
    "prob",
    ["example1", "example2", "example3", "example4", "example5", "example7",
     "circle", "DOTmark_4stitch"],
)
def test_2d_examples(prob):
    r0, r1 = ex.get_example_2d(prob, 33, 49)
    assert r0.shape == r1.shape == (49, 33)  # (ny, nx)
    np.testing.assert_allclose(r0.mean(), 1.0, rtol=1e-10)
    np.testing.assert_allclose(r1.mean(), 1.0, rtol=1e-10)
    assert (r0 >= 0).all() and (r1 >= 0).all()


@pytest.mark.parametrize(
    "prob",
    ["example1", "example2", "circle", "circle2", "example6", "maze14",
     "love-heart"],
)
def test_w2d_examples(prob):
    r0, r1 = w2.get_example_w2d(prob, 33, 33)
    assert r0.shape == (33, 33)
    np.testing.assert_allclose(r0.mean(), 1.0, rtol=1e-10)


def test_weight_by_barrier_layout():
    barrier = w2.barrier_circle_pillar()
    wt = w2.get_weight_by_barrier(33, 33, 9, barrier)
    assert wt.q0.shape == (8, 33, 33)
    assert wt.bs[0].shape == (9, 32, 33)  # y faces
    assert wt.bs[1].shape == (9, 33, 32)  # x faces
    assert np.all(np.asarray(wt.q0) == 1.0)  # time block is 1
    vals = np.unique(np.asarray(wt.bs[1]))
    assert set(vals).issubset({1.0, w2.BARRIER_WEIGHT})
    assert w2.BARRIER_WEIGHT in vals  # the circle blocks some x-faces


def test_weight_restriction_log_space_keeps_walls():
    from dotsocp.multilevel.transfer import restrict_staggered

    barrier = w2.barrier_circle_pillar()
    wt = w2.get_weight_by_barrier(65, 65, 17, barrier)
    wc = restrict_staggered(wt, log_space=True)
    assert wc.q0.shape == (8, 33, 33)
    # geometric-mean restriction keeps interior walls enormous
    assert float(np.asarray(wc.bs[1]).max()) > 1e4


def test_radial_weights_normalized():
    wt = w2.gene_weight_circle(9, 33, 33)
    bx = np.asarray(wt.bs[1])
    np.testing.assert_allclose(bx[0].mean(), 1.0, rtol=1e-10)


def test_barrier_validity_checks():
    r0, r1 = w2.get_example_w2d("circle2", 33, 33)
    barrier = w2.barrier_circle_pillar()
    r0v, r1v, mask = w2.ensure_barrier_validity(r0, r1, barrier)
    assert mask.any()
    assert (np.asarray(r0v)[mask] == 0).all()
    w2.check_barrier_validity(r0v, r1v, barrier)  # passes after cleaning
    bad = np.ones_like(r0)
    with pytest.raises(ValueError):
        w2.check_barrier_validity(bad, bad, barrier)


def test_example_from_images(tmp_path):
    from PIL import Image

    a = (np.linspace(0, 255, 64 * 64).reshape(64, 64)).astype(np.uint8)
    p0 = tmp_path / "a.png"
    p1 = tmp_path / "b.png"
    Image.fromarray(a).save(p0)
    Image.fromarray(a.T).save(p1)
    r0, r1 = ex.get_example_from_images(str(p0), str(p1), 33, 49)
    assert r0.shape == (49, 33)
    np.testing.assert_allclose(r0.mean(), 1.0, rtol=1e-10)
