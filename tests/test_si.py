"""utils/si.py — the minimal SIUnits.h port (SURVEY.md §2.1 #6).

Checks the operator semantics of SIUnits.h:37-58 (multiplication adds
dimension exponents, division subtracts, +/- require equal dimensions) and
the one live-use contract: light-area accumulation typed as siArea
(kernel.cu:422) and stripped raw at the device boundary (kernel.cu:468).
"""

import pytest

from cudapathtracer.utils.si import (
    AREA,
    DIMLESS,
    LENGTH,
    Quantity,
    check_area,
    si_area,
)


def test_dimension_propagation():
    a = Quantity(2.0, LENGTH)
    b = Quantity(3.0, LENGTH)
    area = a * b
    assert area.dim == AREA and area.raw == 6.0
    assert (area / a).dim == LENGTH
    assert (a / b).dim == DIMLESS


def test_add_requires_same_dimension():
    assert (si_area(1.0) + si_area(2.0)).raw == 3.0
    with pytest.raises(TypeError):
        si_area(1.0) + Quantity(1.0, LENGTH)


def test_check_area_boundary():
    assert check_area(si_area(0.1786)) == pytest.approx(0.1786)
    with pytest.raises(TypeError):
        check_area(Quantity(1.0, LENGTH))


def test_scene_light_area_is_typed():
    # the live-use path: make_scene accumulates light area through si_area
    import numpy as np

    from cudapathtracer.models.scene import make_scene

    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    tris = np.array([[0, 1, 2]], np.int32)
    scene = make_scene(verts, tris, np.zeros(1, np.int32),
                       albedo=np.ones((1, 3)), emission=np.ones((1, 3)))
    assert float(scene.total_light_area) == pytest.approx(0.5)
