"""nerfnav_tpu_torch mesh export vs the JAX package's, on the CPU: marching
tetrahedra, extract_geometry, the OBJ / PLY writers and Trainer.save_mesh
(tests/test_mesh.py's cases). On the same density lattice vertices and faces
must be equal exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfnav_tpu.utils import mesh as jmesh
from nerfnav_tpu_torch.models.network import density
from nerfnav_tpu_torch.utils import mesh as tmesh
from test_mesh import sphere_sdf_field

torch.set_num_threads(1)


@pytest.mark.parametrize("res,radius,level", [(32, 10.0, 0.0), (24, 8.0, 0.0), (12, 4.0, 1.5),
                                              (8, 3.0, 100.0)])
def test_marching_tetrahedra_exact(res, radius, level):
    """Vertices and faces equal the reference's on test_mesh.py's spheres
    (and an empty level set); a closed sphere has Euler characteristic 2."""
    field = sphere_sdf_field(res=res, radius=radius)
    vj, fj = jmesh.marching_tetrahedra(field, level)
    vt, ft = tmesh.marching_tetrahedra(field, level)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)
    if level > radius:
        assert len(vt) == len(ft) == 0
        return
    edges = {tuple(sorted(e)) for a, b, c in ft for e in ((a, b), (b, c), (a, c))}
    assert len(vt) - len(edges) + len(ft) == 2
    r = np.linalg.norm(vt - (res - 1) / 2, axis=-1)
    np.testing.assert_allclose(r, radius - level, atol=0.5)


@pytest.mark.parametrize("res,chunk", [(48, 2**16), (20, 4096)])
def test_extract_geometry_exact(res, chunk):
    """extract_geometry over the same density (1 - the L-inf norm: the same
    float32 values in both packages) in chunks, the last padded: the field,
    vertices and faces exactly; the surface is the cube |x| = 0.5."""
    vj, fj, gj = jmesh.extract_geometry(lambda x: 1.0 - jnp.max(jnp.abs(x), axis=-1), 1.0,
                                        resolution=res, threshold=0.5, chunk=chunk)
    calls = []

    def linf(x):
        calls.append(x.shape[0])
        return 1.0 - x.abs().amax(dim=-1)

    vt, ft, gt = tmesh.extract_geometry(linf, 1.0, resolution=res, threshold=0.5,
                                        chunk=chunk, device="cpu")
    assert set(calls) == {chunk} and len(calls) == -(-res**3 // chunk)
    np.testing.assert_array_equal(gt, gj)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)
    assert len(vt) > 0
    np.testing.assert_allclose(np.abs(vt).max(axis=-1), 0.5, atol=2.0 / (res - 1))


def test_writers_match(tmp_path):
    """save_obj and save_ply write the reference's bytes."""
    verts, faces = tmesh.marching_tetrahedra(sphere_sdf_field(res=12, radius=4.0), 0.0)
    for ext in ("obj", "ply"):
        save_j, save_t = getattr(jmesh, f"save_{ext}"), getattr(tmesh, f"save_{ext}")
        save_j(str(tmp_path / f"j.{ext}"), verts, faces)
        save_t(str(tmp_path / "sub" / f"t.{ext}"), verts, faces)
        assert (tmp_path / f"j.{ext}").read_bytes() == (tmp_path / "sub" / f"t.{ext}").read_bytes()
    lines = (tmp_path / "sub" / "t.obj").read_text().splitlines()
    assert sum(line.startswith("v ") for line in lines) == len(verts) > 0
    assert f"element face {len(faces)}" in (tmp_path / "sub" / "t.ply").read_text()


@pytest.mark.parametrize("backend", ["xla", "fused"])
def test_save_mesh_matches_jax(backend, tmp_path):
    """Trainer.save_mesh on a tiny field (the EMA params through the MLP
    backend) writes a PLY with the reference trainer's vertex and face
    counts, and an OBJ where the path asks for one."""
    from test_torch_render import _net_cfg, _trainers

    tj, tt, _, _ = _trainers(tmp_path, _net_cfg(mlp_backend=backend), 1.0, {})
    # a bar inside the random field's range, so the surface is not empty
    _, _, field = tmesh.extract_geometry(
        lambda x: density(tt.state.ema_params, x, tt.cfg)["sigma"], 1.0, resolution=16,
        device="cpu")
    thresh = float(np.median(field))
    pj = tj.save_mesh(str(tmp_path / "j.ply"), resolution=16, threshold=thresh)
    pt = tt.save_mesh(str(tmp_path / "t.ply"), resolution=16, threshold=thresh)
    head_j, head_t = (open(p).read().split("end_header")[0] for p in (pj, pt))
    assert head_t == head_j and "element vertex 0" not in head_t
    default = tt.save_mesh(resolution=8, threshold=thresh)
    assert default.endswith("meshes/port_0.ply")
    obj = tt.save_mesh(str(tmp_path / "t.obj"), resolution=8, threshold=thresh)
    assert open(obj).read().startswith("v ")


def test_extract_geometry_needs_cuda_or_cpu():
    """The default device is the card: without one, extract_geometry raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tmesh.extract_geometry(lambda x: x[:, 0], 1.0, resolution=4)
