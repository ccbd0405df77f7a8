"""The port's io modules (fluidnet_tpu_torch.io, copies of the JAX
package's backend-free code) against fluidnet_tpu.io on the same inputs:
the OBJ voxelizer (its solid fill on each package's native flood fill, and
on the NumPy fallbacks), .binvox import and export, .vbox export, voxel
placement and the obstacle OBJ export. Nothing here computes in floating
point beyond what both copies do alike: every comparison is exact (equal
arrays, equal bytes).
"""

import numpy as np
import pytest

from fluidnet_tpu.io import binvox as j_binvox
from fluidnet_tpu.io import obj_export as j_obj_export
from fluidnet_tpu.io import vbox as j_vbox
from fluidnet_tpu.io import voxel_utils as j_vu
from fluidnet_tpu.io import voxelize as j_voxelize

from fluidnet_tpu_torch import native
from fluidnet_tpu_torch.io import binvox, obj_export, vbox, voxelize
from fluidnet_tpu_torch.io import voxel_utils as vu

from chip_smoke import write_scene_obj
from tests.torch_port_util import jax_native

DIM = 16


@pytest.fixture(scope="module")
def obj(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("io") / "scene.obj")
    write_scene_obj(path)
    return path


def test_voxelize_obj_matches_jax(obj):
    t = voxelize.voxelize_obj(obj, dim=DIM)
    j = j_voxelize.voxelize_obj(obj, dim=DIM)
    np.testing.assert_array_equal(t["data"], j["data"])
    assert t["dims"] == j["dims"] and t["scale"] == j["scale"]
    assert t["translation"] == j["translation"]
    occ = t["data"] > 0.5
    # Solid, not a shell: the box's and the sphere's interiors are filled.
    assert occ.sum() > voxelize._surface_voxels(
        *voxelize.load_obj(obj), DIM).sum()


def serpentine_surface(dim=DIM, z=7):
    """A solid cube but for one corridor of free cells: it leaves the grid
    at one boundary cell (x 0, y 1) and snakes through plane z in rows y =
    1, 3, .., 13 joined at alternate ends, 105 cells, every one exterior."""
    surf = np.ones((dim,) * 3, bool)
    surf[0, 1, z] = False
    for r, y in enumerate(range(1, dim - 2, 2)):
        surf[1:dim - 1, y, z] = False
        if y + 2 < dim - 1:
            surf[dim - 2 if r % 2 == 0 else 1, y + 1, z] = False
    return surf


def test_fill_interior_serpentine_matches_jax_native(monkeypatch):
    """The exterior is one corridor 105 cells long, past the 3 * dim = 48
    rounds of the dilation fallback: the flood fill keeps it all free
    (4096 - 105 solid), the dilation fills its last 56 cells."""
    surf = serpentine_surface()
    assert (~surf).sum() == 105
    j_native = jax_native()
    assert native.get_lib() is not None
    want = j_voxelize._fill_interior(surf)
    got = voxelize._fill_interior(surf)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == DIM ** 3 - 105
    monkeypatch.setattr(j_native, "get_lib", lambda: None)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    j_fallback = j_voxelize._fill_interior(surf)
    with pytest.warns(RuntimeWarning, match="dilation"):
        fallback = voxelize._fill_interior(surf)
    np.testing.assert_array_equal(fallback, j_fallback)
    assert (fallback != want).sum() == 56


def test_binvox_round_trip_and_bytes(obj, tmp_path):
    vox = voxelize.voxelize_obj(obj, dim=DIM)
    tp, jp = str(tmp_path / "t.binvox"), str(tmp_path / "j.binvox")
    voxelize.save_binvox(tp, vox)
    j_voxelize.save_binvox(jp, vox)
    with open(tp, "rb") as a, open(jp, "rb") as b:
        assert a.read() == b.read()
    t, j = binvox.load_binvox(tp), j_binvox.load_binvox(tp)
    np.testing.assert_array_equal(t["data"], vox["data"])
    np.testing.assert_array_equal(t["data"], j["data"])
    raw = open(tp, "rb").read().split(b"data\n", 1)[1]
    np.testing.assert_array_equal(native.binvox_decode_native(raw, DIM ** 3),
                                  binvox._decode_rle_numpy(raw, DIM ** 3))
    assert (t["dims"], t["translation"], t["scale"]) == \
        (j["dims"], j["translation"], j["scale"])


def test_voxel_utils_match_jax(obj):
    vox = voxelize.voxelize_obj(obj, dim=DIM)["data"]
    for axis in (0, 1, 2):
        np.testing.assert_array_equal(vu.flip_diagonal(vox, axis),
                                      j_vu.flip_diagonal(vox, axis))
    flipped = vu.flip_diagonal(vox, 1)
    for dims, off in (((20, 18, 24), (0, 0, 0)), ((16, 16, 16), (1, -2, 3))):
        t = vu.pad_voxels_to_dims(*dims, flipped, *off)
        np.testing.assert_array_equal(t, j_vu.pad_voxels_to_dims(
            *dims, flipped, *off))
    padded = vu.pad_voxels_to_dims(20, 18, 24, flipped)
    flags = np.ones((1, 1, 24, 18, 20), np.int32)
    t = vu.place_voxels_in_flags(flags, padded)
    np.testing.assert_array_equal(t, j_vu.place_voxels_in_flags(flags,
                                                                padded))
    assert (t == 2).sum() == (padded > 0.5).sum()


def test_vbox_bytes_and_read_back(tmp_path):
    rng = np.random.default_rng(3)
    frames = rng.random((3, 6, 5, 4)).astype(np.float32)
    paths = []
    for mod, name in ((vbox, "t.vbox"), (j_vbox, "j.vbox")):
        path = str(tmp_path / name)
        with mod.VboxWriter(path, 4, 5, 6, 3) as w:
            for fr in frames:
                w.write_frame(fr)
        paths.append(path)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    got, whd = vbox.read_vbox(paths[0])
    assert whd == (4, 5, 6)
    np.testing.assert_array_equal(got, frames)


def test_export_obstacles_obj_matches_jax(obj, tmp_path):
    vox = voxelize.voxelize_obj(obj, dim=DIM)["data"]
    flags = np.where(vox > 0.5, 2, 1).astype(np.int32)
    for name, vol in (("flags", flags), ("occupancy", vox)):
        tp, jp = str(tmp_path / f"t_{name}.obj"), str(tmp_path / f"j_{name}.obj")
        t = obj_export.export_obstacles_obj(tp, vol)
        assert t == j_obj_export.export_obstacles_obj(jp, vol)
        with open(tp) as a, open(jp) as b:
            assert a.read() == b.read()
        assert t[1] > 0
