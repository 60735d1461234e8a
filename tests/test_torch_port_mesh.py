"""The port's mesh layer (airpollution_tpu_torch.mesh, ops/stencil
patterns) against the JAX package's: identical arrays from the same
structured meshes."""

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

import airpollution_tpu as japt
from airpollution_tpu.mesh import topology as j_topo
from airpollution_tpu.ops import stencil as j_stencil
from airpollution_tpu.ops import uniform as j_uniform

import airpollution_tpu_torch as tapt
from airpollution_tpu_torch.mesh import structured_grid
from airpollution_tpu_torch.mesh import topology as t_topo
from airpollution_tpu_torch.ops import stencil as t_stencil
from airpollution_tpu_torch.ops import uniform as t_uniform


def _pair(ms, nt=8):
    jmd = japt.MeshData(japt.create_mesh(ms, 20.0), japt.Domain(), nt=nt,
                        dtype=jnp.float64)
    tmd = tapt.MeshData(tapt.create_mesh(ms, 20.0), tapt.Domain(), nt=nt,
                        dtype=torch.float64, device="cpu")
    return jmd, tmd


FIELDS = ["points", "triangles", "segments", "triangle_to_segments",
          "midpoints", "segment_lengths", "triangle_areas",
          "boundary_segments", "boundary_triangles",
          "boundary_triangle_first_segment", "boundary_mask",
          "ell_cols", "ell_entry_to_slot", "ell_diag_slot"]


@pytest.mark.parametrize("ms", [5, 17, 32])
def test_meshdata_fields_equal_jax(ms):
    jmd, tmd = _pair(ms)
    for name in FIELDS:
        np.testing.assert_array_equal(
            getattr(tmd, name).numpy(), np.asarray(getattr(jmd, name)),
            err_msg=name,
        )
    # linspace rounds differently in the two frameworks.
    np.testing.assert_allclose(tmd.time_discr.numpy(),
                               np.asarray(jmd.time_discr), rtol=1e-15)
    assert tmd.diameter == jmd.diameter
    assert tmd.ell_width == jmd.ell_width
    assert tmd.structured_n == jmd.structured_n == ms
    assert structured_grid(tmd) == pytest.approx(
        japt.mesh.data.structured_grid(jmd), rel=0, abs=0)


def test_ms32_counts():
    _, tmd = _pair(32)
    assert tmd.number_of_points == 1024
    assert tmd.number_of_triangles == 1922
    assert tmd.number_of_segments == 2945
    assert int(tmd.boundary_mask.sum()) == 124
    assert tmd.diameter == pytest.approx(1.8248, abs=1e-4)


def test_create_mesh_and_topology_equal_jax():
    jm = japt.create_mesh(12, 3.0)
    tm = tapt.create_mesh(12, 3.0)
    np.testing.assert_array_equal(tm.points, jm.points)
    np.testing.assert_array_equal(tm.triangles, jm.triangles)
    jt = j_topo.enumerate_edges(jm.triangles, jm.points.shape[0])
    tt = t_topo.enumerate_edges(tm.triangles, tm.points.shape[0])
    for f in ("segments", "triangle_to_segments", "boundary_segments",
              "boundary_triangles", "boundary_triangle_first_segment"):
        np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f))
    jp = j_topo.build_ell_pattern(jt.triangle_to_segments,
                                  jt.segments.shape[0])
    tp = t_topo.build_ell_pattern(tt.triangle_to_segments,
                                  tt.segments.shape[0])
    for f in ("cols", "entry_to_slot", "diag_slot"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f))
    assert tp.width == jp.width


@pytest.mark.parametrize("ms", [3, 9, 17])
def test_stencil_pattern_and_uniform_spec_equal_jax(ms):
    jmd, tmd = _pair(ms)
    jp = j_stencil.get_pattern(jmd)
    tp = t_stencil.get_pattern(tmd)
    np.testing.assert_array_equal(tp.perm, jp.perm)
    np.testing.assert_array_equal(tp.inv_perm, jp.inv_perm)
    for a, b in zip(tp.term_slots, jp.term_slots):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tp.term_valid, jp.term_valid):
        np.testing.assert_array_equal(a, b)
    perm, inv = t_stencil.get_family_perm(tmd)
    np.testing.assert_array_equal(perm, jp.perm)
    js = j_uniform.build_uniform_spec(jp)
    ts = t_uniform.build_uniform_spec(tp)
    np.testing.assert_array_equal(ts.center_slots, js.center_slots)
    np.testing.assert_array_equal(ts.center_dofs, js.center_dofs)
    assert ts.interior_rects == js.interior_rects


def test_mirror_tagged_mesh_is_refused():
    import dataclasses

    mesh = dataclasses.replace(tapt.create_mesh(5, 1.0), mirror=(-1, 1))
    with pytest.raises(ValueError, match="mirror"):
        tapt.MeshData(mesh, tapt.Domain(), nt=4, device="cpu")
    md = tapt.MeshData(mesh, tapt.Domain(), nt=4, device="cpu",
                       mirror_ok=True)
    assert md.number_of_segments == 56


def test_problem_and_domain_equal_jax():
    rng = np.random.default_rng(0)
    xyt = rng.uniform(-20, 20, size=(50, 3))
    xyt[:, 2] = rng.uniform(0, 10, size=50)
    for kw in ({}, {"v": (0.3, -0.7), "D": 0.2, "sigma": 1.5},
               {"reaction": 0.05}):
        jp, tp = japt.Problem(**kw), tapt.Problem(**kw)
        t = torch.tensor(xyt)
        np.testing.assert_allclose(tp.analytical_solution(t).numpy(),
                                   np.asarray(jp.analytical_solution(xyt)),
                                   rtol=1e-13, atol=0)
        np.testing.assert_allclose(tp.boundary_fn(t).numpy(),
                                   np.asarray(jp.boundary_fn(xyt)),
                                   rtol=1e-13, atol=0)
        np.testing.assert_allclose(
            tp.initial_condition_fn(t[:, :2]).numpy(),
            np.asarray(jp.initial_condition_fn(xyt[:, :2])),
            rtol=1e-13, atol=0)
        assert tp.zero_source and jp.zero_source
        assert not tp.source_term(t).any()
    pts = np.array([[-20.0, 3.0], [1.0, 20.0], [0.0, 0.0], [5.0, -20.0]])
    np.testing.assert_array_equal(
        tapt.Domain().is_boundary(torch.tensor(pts)).numpy(),
        np.asarray(japt.Domain().is_boundary(pts)))
