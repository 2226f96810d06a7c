"""The port's mesh generators, reader and writer against the JAX
package's (host NumPy in both).

  * ``box_mesh``, ``sphere_mesh(4)``, ``channel2D(0.1)`` and
    ``channel3D(0.1)``: coordinates, cells, tags, plane and periodic
    pairs bit-identical (``np.array_equal``);
  * ``write_msh`` -> ``read_msh`` round-trips in 2D and 3D (vertices to
    1e-12, cells as sets, tag closures), both writers emit the same
    file, and a file written by either package reads identically in the
    other;
  * tests/test_mesh.py's inline ``GMSH_SAMPLE`` parses the same way;
  * ``native.partition_cells`` and ``native.parse_msh_fast`` return the
    JAX package's arrays on tests/test_native.py's cases, through the
    native library and with it absent.
"""

import numpy as np
import pytest

import nupgcm_tpu as npj
import nupgcm_tpu_torch as npt
from test_mesh import GMSH_SAMPLE
from torch_parity import assert_same_rcm_branch

GENERATORS = {
    "box_mesh": ((2, 3, 2), dict(lo=(-1.0, 0.0, -0.5), hi=(1.0, 0.5, 0.0))),
    "sphere_mesh": ((4,), {}),
    "channel2D": ((0.1,), {}),
    "channel3D": ((0.1,), {}),
}


def assert_meshes_equal(a, b):
    assert a.tdim == b.tdim
    for k in ("coords", "cells", "edges", "cell_edges"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and np.array_equal(x, y), k
    assert (a.periodic_pairs is None) == (b.periodic_pairs is None)
    if a.periodic_pairs is not None:
        assert np.array_equal(a.periodic_pairs, b.periodic_pairs)
        assert np.array_equal(a.periodic_edge_pairs(), b.periodic_edge_pairs())
    assert a.plane == b.plane
    assert sorted(a.tagged) == sorted(b.tagged)
    for name, groups in a.tagged.items():
        assert sorted(groups) == sorted(b.tagged[name]), name
        for d, s in groups.items():
            assert np.array_equal(np.asarray(s), np.asarray(b.tagged[name][d])), (name, d)


@pytest.mark.parametrize("name", list(GENERATORS))
def test_generators_bit_identical(name):
    assert_same_rcm_branch()
    args, kw = GENERATORS[name]
    mj = getattr(npj.generators, name)(*args, **kw)
    mt = getattr(npt.generators, name)(*args, **kw)
    assert isinstance(mt, npt.Mesh)
    assert_meshes_equal(mj, mt)
    if name == "channel3D":
        assert len(mt.periodic_pairs) > 0
        # the port's periodic identification on the generated seam
        bj = npj.Spaces(mj, b_diri_tags=[], b_diri_vals=[]).b_space
        bt = npt.Spaces(mt, b_diri_tags=[], b_diri_vals=[]).b_space
        assert np.array_equal(bj.active, bt.active)
        assert np.array_equal(bj.cell_dofs, bt.cell_dofs)


@pytest.mark.parametrize("mesh_fn", [lambda g: g.bowl2D(0.2, 0.5),
                                     lambda g: g.bowl3D(0.4, 0.5, nz=2)],
                         ids=["2D", "3D"])
def test_msh_round_trip_and_cross_package(mesh_fn, tmp_path):
    mt = mesh_fn(npt.generators)
    pt, pj = str(tmp_path / "t.msh"), str(tmp_path / "j.msh")
    npt.write_msh(mt, pt)
    npj.write_msh(mesh_fn(npj.generators), pj)
    # the two writers emit the same file
    assert open(pt).read() == open(pj).read()
    # vertices (to the file's printed precision), cells as sets and the
    # physical-group closures survive the round trip
    back = npt.read_msh(pt)
    assert (back.tdim, back.n_vertices, back.n_cells) == (mt.tdim, mt.n_vertices, mt.n_cells)
    assert np.allclose(back.coords, mt.coords, rtol=0, atol=1e-12)
    cells = lambda m: set(map(tuple, np.sort(m.cells, axis=1)))
    assert cells(back) == cells(mt)
    for t in mt.tag_names():
        assert set(mt.tag_closure([t])[0]) == set(back.tag_closure([t])[0]), t
    # either package reads the other's file to the same mesh
    assert_meshes_equal(npj.read_msh(pt), npt.read_msh(pj))


def test_gmsh_sample_parses_the_same(tmp_path):
    p = tmp_path / "sample.msh"
    p.write_text(GMSH_SAMPLE)
    mj, mt = npj.read_msh(str(p)), npt.read_msh(str(p))
    assert mt.tdim == 2 and mt.n_cells == mj.n_cells
    assert_meshes_equal(mj, mt)
    from nupgcm_tpu.mesh.gmsh_reader import read_msh_arrays as read_j

    from nupgcm_tpu_torch.mesh.gmsh_reader import read_msh_arrays as read_t

    (xj, cj, tj, dj), (xt, ct, tt, dt) = read_j(str(p)), read_t(str(p))
    assert dj == dt and np.array_equal(xj, xt) and np.array_equal(cj, ct)
    assert sorted(tj) == sorted(tt)
    for name in tj:
        for d in tj[name]:
            assert np.array_equal(tj[name][d], tt[name][d]), (name, d)


def test_native_loader_rebuilds_a_broken_library(tmp_path):
    """A ``native/libmeshkit.so`` that exists but does not load (a build
    killed half-way) and is newer than its source is rebuilt by the
    port's loader, not taken as built: a copy of the loader and of
    native/'s sources in ``tmp_path``, whose library gives the same RCM
    ordering as the repository's."""
    import importlib.util
    import os
    import pathlib
    import shutil

    import scipy.sparse as sp

    from nupgcm_tpu_torch.mesh import native

    root = pathlib.Path(__file__).resolve().parents[1]
    (tmp_path / "pkg" / "mesh").mkdir(parents=True)
    shutil.copy(root / "nupgcm_tpu_torch" / "mesh" / "native.py", tmp_path / "pkg" / "mesh")
    (tmp_path / "native").mkdir()
    for f in ("Makefile", "meshkit.cpp"):
        shutil.copy(root / "native" / f, tmp_path / "native")
    lib = tmp_path / "native" / "libmeshkit.so"
    lib.write_bytes(b"\x7fELF\x02\x01\x01" + bytes(57))
    later = os.stat(tmp_path / "native" / "meshkit.cpp").st_mtime + 100
    os.utime(lib, (later, later))

    spec = importlib.util.spec_from_file_location("native_copy",
                                                  tmp_path / "pkg" / "mesh" / "native.py")
    copy = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(copy)
    assert not copy._loads(str(lib))
    assert copy.load() is not None
    assert copy._loads(str(lib))
    mesh = npt.generators.box_mesh(3, 2, 2)
    n = mesh.n_vertices
    e = mesh.edges
    g = sp.coo_matrix((np.ones(2 * len(e)), (np.r_[e[:, 0], e[:, 1]], np.r_[e[:, 1], e[:, 0]])),
                      shape=(n, n)).tocsr()
    assert native.load() is not None
    assert np.array_equal(copy.rcm(g.indptr, g.indices), native.rcm(g.indptr, g.indices))


def _without_native(monkeypatch):
    """Both packages as if ``native/libmeshkit.so`` were absent."""
    from nupgcm_tpu.mesh import native as native_j

    from nupgcm_tpu_torch.mesh import native as native_t

    for mod in (native_j, native_t):
        monkeypatch.setattr(mod, "load", lambda build=True: None)


@pytest.mark.parametrize("lib", ["native", "absent"])
def test_partition_cells_matches_jax(lib, monkeypatch):
    """tests/test_native.py's case: the RCM-ordered P2 space of
    bowl3D(0.15) in 4 parts."""
    from nupgcm_tpu.fem.spaces import ScalarSpace as ScalarSpaceJ
    from nupgcm_tpu.mesh import native as native_j

    from nupgcm_tpu_torch.fem.spaces import ScalarSpace
    from nupgcm_tpu_torch.mesh import native as native_t

    assert_same_rcm_branch()
    mesh = npt.generators.bowl3D(0.15, 0.5)
    s = ScalarSpace(mesh, 2)
    s.renumber(s.rcm_permutation())
    sj = ScalarSpaceJ(npj.generators.bowl3D(0.15, 0.5), 2)
    sj.renumber(sj.rcm_permutation())
    assert np.array_equal(s.cell_dofs, sj.cell_dofs)
    if lib == "absent":
        _without_native(monkeypatch)
    elif native_t.load() is None:
        pytest.skip("native meshkit not buildable in this environment")
    parts = native_t.partition_cells(s.cell_dofs, s.ndof, 4)
    ref = native_j.partition_cells(sj.cell_dofs, sj.ndof, 4)
    assert parts.dtype == ref.dtype == np.int32 and np.array_equal(parts, ref)
    counts = np.bincount(parts, minlength=4)
    assert counts.sum() == mesh.n_cells and counts.min() > 0.25 * counts.max()


@pytest.mark.parametrize("lib", ["native", "absent"])
def test_parse_msh_fast_matches_jax(lib, monkeypatch, tmp_path):
    """The inline GMSH_SAMPLE (tests/test_native.py's case) and a 3D
    bowl written by write_msh: the same nodes, ids and element blocks;
    None from both without the library."""
    from nupgcm_tpu.mesh import native as native_j

    from nupgcm_tpu_torch.mesh import native as native_t

    sample, bowl = tmp_path / "sample.msh", tmp_path / "bowl.msh"
    sample.write_text(GMSH_SAMPLE)
    npt.write_msh(npt.generators.bowl3D(0.4, 0.5, nz=2), str(bowl))
    if lib == "absent":
        _without_native(monkeypatch)
    elif native_t.load() is None:
        pytest.skip("native meshkit not buildable in this environment")
    for path in (sample, bowl):
        got, ref = native_t.parse_msh_fast(str(path)), native_j.parse_msh_fast(str(path))
        if lib == "absent":
            assert got is None and ref is None
            continue
        (x, ids, blocks), (xj, idsj, blocksj) = got, ref
        assert np.array_equal(x, xj) and np.array_equal(ids, idsj)
        assert len(blocks) == len(blocksj) > 0
        for b, bj in zip(blocks, blocksj):
            assert b[:3] == bj[:3] and np.array_equal(b[3], bj[3]), b[:3]
    if lib == "native":
        coords, _, blocks = native_t.parse_msh_fast(str(sample))
        assert coords.shape == (4, 3)
        assert sum(b[3].shape[0] for b in blocks if b[0] == 2) == 2
        assert native_t.parse_msh_fast(str(tmp_path / "missing.msh")) is None
