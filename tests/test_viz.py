"""Viz layer smoke tests: every plotting entry point renders and saves."""
import os

import numpy as np

from dotsocp.viz import plots


def _fake_solution():
    nt, ny, nx = 5, 17, 17
    t = np.linspace(0, 1, nt)[:, None, None]
    y = np.linspace(0, 1, ny)[None, :, None]
    x = np.linspace(0, 1, nx)[None, None, :]
    rho = np.exp(-((x - 0.3 - 0.4 * t) ** 2 + (y - 0.5) ** 2) / 0.02)
    Ex = 0.4 * rho
    Ey = np.zeros_like(rho)
    return rho, Ex, Ey


def test_all_plots_render(tmp_path):
    rho, Ex, Ey = _fake_solution()
    out = []

    def p(name):
        path = str(tmp_path / name)
        out.append(path)
        return path

    plots.show_evolution_1d(rho[:, 8, :], "join", save=p("e1j.png"))
    plots.show_evolution_1d(rho[:, 8, :], "tile", save=p("e1t.png"))
    for mode in ("imshow", "contourf", "contour", "contour3", "mesh"):
        plots.show_evolution_2d(rho, mode, save=p(f"e2{mode}.png"))
    mask = np.zeros(rho.shape[1:], bool)
    mask[5:8, 5:8] = True
    # per-mode barrier painting (show_evolution_2d.m:30-48)
    for mode in ("imshow", "contourf", "contour", "contour3"):
        plots.show_evolution_2d(rho, mode, barrier_mask=mask,
                                save=p(f"e2b_{mode}.png"))
    import pytest

    with pytest.raises(ValueError):
        plots.show_evolution_2d(rho, "mesh", barrier_mask=mask)
    plots.show_movement_2d(rho, Ex, Ey, save=p("mv.png"))
    kkt = np.abs(np.random.default_rng(0).standard_normal((20, 7))) * 1e-3
    plots.show_residual_curve(kkt, names=[f"k{i}" for i in range(7)],
                              save=p("rc.png"))
    plots.hist_negative_density(rho - 0.1, save=p("hn.png"))
    plots.hist_violation_q(rho[:-1], [Ex[:-1], Ey[:-1]], save=p("hv.png"))
    # named hist_positive_value.m port (dual-axis log10 bins), incl. the
    # all-zero edge case
    plots.hist_positive_value(rho - 0.1, save=p("hp.png"))
    plots.hist_positive_value(np.zeros(8), save=p("hp0.png"))
    for path in out:
        assert os.path.exists(path) and os.path.getsize(path) > 0, path


def test_export_evolution_2d_publication(tmp_path):
    """Publication exporter (export_evolution_2d.m): per-frame image
    series with the timestamp naming rule, pdf output, gif animation,
    and the mp4 gate."""
    import pytest

    rho, _, _ = _fake_solution()
    # png series, 3 frames: name-t=0.00.png ... name-t=1.00.png
    paths = plots.export_evolution_2d(rho, str(tmp_path / "ev.png"),
                                      num_frame=3, dpi=72)
    assert [os.path.basename(p) for p in paths] == [
        "ev-t=0.00.png", "ev-t=0.50.png", "ev-t=1.00.png"
    ]
    # pdf single frame, contourf mode with colorbar
    paths = plots.export_evolution_2d(rho, str(tmp_path / "ev.pdf"),
                                      num_frame=2, mode="contourf",
                                      colorbar=True, dpi=72)
    assert all(p.endswith(".pdf") and os.path.getsize(p) > 0 for p in paths)
    # gif animation via the pillow writer
    (gif,) = plots.export_evolution_2d(rho, str(tmp_path / "ev.gif"), dpi=40)
    assert os.path.getsize(gif) > 0
    # video export: FFMpegWriter when ffmpeg exists, else a warned gif
    # fallback at the requested stem (the returned path tells the truth)
    from matplotlib import animation

    if animation.writers.is_available("ffmpeg"):
        (vid,) = plots.export_evolution_2d(rho, str(tmp_path / "evm.mp4"),
                                           dpi=40)
        assert vid.endswith(".mp4") and os.path.getsize(vid) > 0
    else:
        with pytest.warns(UserWarning, match="ffmpeg"):
            (vid,) = plots.export_evolution_2d(rho, str(tmp_path / "evm.mp4"),
                                               dpi=40)
        assert vid.endswith("evm.gif") and os.path.getsize(vid) > 0


def test_show_evolution_3d_renders(tmp_path):
    rho = np.abs(np.random.default_rng(0).standard_normal((5, 7, 8, 9)))
    p = str(tmp_path / "e3.png")
    plots.show_evolution_3d(rho, save=p)
    assert os.path.exists(p) and os.path.getsize(p) > 0


def test_example_3d_generators():
    from dotsocp.models.examples import get_example_3d

    for prob in ("gaussian", "split8"):
        rho0, rho1 = get_example_3d(prob, 9, 11, 13)
        assert rho0.shape == (13, 11, 9)
        np.testing.assert_allclose(rho0.mean(), 1.0, rtol=1e-12)
        np.testing.assert_allclose(rho1.mean(), 1.0, rtol=1e-12)
        assert (rho0 >= 0).all() and (rho1 >= 0).all()


def test_violation_q_formula():
    q0 = np.array([[-1.0, 0.5]])
    bs = [np.array([[1.0, 2.0]])]
    f = plots.violation_q(q0, bs)
    np.testing.assert_allclose(f, [[-0.5, 2.5]])
