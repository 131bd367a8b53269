"""Native geometry runtime vs numpy reference implementations."""

import numpy as np
import pytest

from tacex_tpu import native
from tacex_tpu.physics.soft import mesh as pymesh


@pytest.fixture(autouse=True)
def _native_lib():
    if not native.available():
        pytest.skip("no C++ compiler to build native/libtacex_geom.so")


class TestNativeGeom:
    def test_box_tet_mesh_matches_python(self):
        res, size, center = (4, 5, 3), (0.02, 0.025, 0.0045), (0.001, -0.002, 0.0)
        pts_c, tets_c = native.box_tet_mesh(res, size, center)
        ref = pymesh.box_tet_mesh(size, res, center)
        np.testing.assert_allclose(pts_c, ref.points, atol=1e-6)
        np.testing.assert_array_equal(tets_c, ref.tets)

    def test_extract_surface_matches_python(self):
        ref = pymesh.box_tet_mesh((0.02, 0.02, 0.005), (3, 3, 2))
        faces_c = native.extract_surface(ref.tets, ref.points)
        # same face set (orientation canonicalized by sorting rows then rows)
        def canon(f):
            rolled = np.stack([np.roll(r, -np.argmin(r)) for r in f])
            return rolled[np.lexsort(rolled.T[::-1])]

        np.testing.assert_array_equal(canon(faces_c), canon(ref.surface_tris))

    def test_lumped_masses_match(self):
        ref = pymesh.box_tet_mesh((0.02, 0.02, 0.005), (3, 3, 2))
        m_c = native.lumped_masses(ref.tets, ref.points, 1000.0)
        from tacex_tpu.physics.soft.fem import lumped_masses as py_masses

        np.testing.assert_allclose(m_c, py_masses(ref.points, ref.tets, 1000.0), rtol=1e-5)

    def test_barycentric_bind(self):
        ref = pymesh.box_tet_mesh((0.02, 0.02, 0.004), (4, 4, 1))
        # bottom face triangles
        z_min = ref.points[:, 2].min()
        on_face = np.abs(ref.points[:, 2] - z_min) < 1e-9
        tris = ref.surface_tris[on_face[ref.surface_tris].all(axis=1)]
        markers = np.array([[0.0, 0.0], [0.004, -0.003], [0.5, 0.5]], np.float32)
        idx, w = native.barycentric_bind(markers, ref.points, tris)
        assert idx[0] >= 0 and idx[1] >= 0
        assert idx[2] == -1  # outside the gel
        for k in range(2):
            tri = tris[idx[k]]
            rec = (ref.points[tri][:, :2] * w[k][:, None]).sum(0)
            np.testing.assert_allclose(rec, markers[k], atol=1e-6)
