"""The port's mesh extraction (lzzx_nerf_tpu_torch/ops/mesh.py) and the
CLI's --save_mesh (cli.run_save_mesh) against the JAX package's on the CPU.

- marching_tetrahedra, extract_geometry, save_obj and save_ply on
  tests/test_mesh.py's volumes: equal (the same numpy code).
- run_save_mesh on a tiny workspace: tests/test_serving.py's toy dataset
  (32²) and a JAX CLI checkpoint whose triplane tables are drawn in ±1,
  carried into the port's checkpoint (state_io.checkpoint_from_jax), meshed
  by both CLIs at resolution 24 and the volume's median density (a surface
  through the whole box). Both fields compute in bfloat16 (--fp16, the
  Config's default). Tolerances: the densities within rtol 2^-11 of JAX's
  (here |h| < 2^-4, where a bfloat16 ulp of the pre-activation h is at
  most 2^-12 and sigma = exp(h)) and at least 3/4 of them bit-equal; a
  float32 field is bit-equal at fewer than 1 % of the points. The port's
  marcher on JAX's densities writes JAX's PLY byte for byte, and the
  port's own PLY has JAX's vertex count within 1 %."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

import lzzx_nerf_tpu.ops.mesh as jmesh
import lzzx_nerf_tpu_torch.ops.mesh as tmesh
from lzzx_nerf_tpu import cli as jcli
from lzzx_nerf_tpu.data.provider import NeRFDataset as JDataset
from lzzx_nerf_tpu.train import TrainState as JState
from lzzx_nerf_tpu.train import Trainer as JTrainer
from lzzx_nerf_tpu.train import build_optimizer
from lzzx_nerf_tpu_torch import cli
from test_torch_cli_test import _carry
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

RES = 24
SIGMA_RTOL = 2.0 ** -11
EQUAL_MIN, EQUAL_F32_MAX = 0.75, 0.01
FLAGS = ["--asr_model", "deepspeech", "--grid_size", "32",
         "--mesh_resolution", str(RES)]


def _sphere(R, r):
    ax = np.linspace(-1, 1, R)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    return r - np.sqrt(X ** 2 + Y ** 2 + Z ** 2)


@pytest.mark.parametrize("vol,iso", [
    (_sphere(48, 0.6), 0.0), (_sphere(32, 0.55), 0.0),
    (-_sphere(32, 0.55), 0.0), (np.zeros((8, 8, 8), np.float32), 0.5)],
    ids=["sphere48", "sphere32", "inverted32", "empty"])
def test_marching_tetrahedra_matches_jax(vol, iso):
    R = vol.shape[0]
    kw = dict(origin=(-1, -1, -1), spacing=(2 / (R - 1),) * 3)
    tv, tf = tmesh.marching_tetrahedra(vol, iso, **kw)
    jv, jf = jmesh.marching_tetrahedra(vol, iso, **kw)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    assert tv.dtype == jv.dtype and tf.dtype == jf.dtype


def test_extract_geometry_and_files_match_jax(tmp_path):
    def query(pts):
        return 10.0 * (np.linalg.norm(pts, axis=-1) < 0.4)

    args = ([-1, -0.5, -1], [1, 0.5, 1])
    tv, tf = tmesh.extract_geometry(*args, resolution=40, threshold=5.0,
                                    query_func=query, chunk=4096)
    jv, jf = jmesh.extract_geometry(*args, resolution=40, threshold=5.0,
                                    query_func=query)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    for name in ("save_obj", "save_ply"):
        getattr(tmesh, name)(str(tmp_path / "t"), tv, tf)
        getattr(jmesh, name)(str(tmp_path / "j"), jv, jf)
        assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()


def _workspace(root):
    """The toy dataset and a JAX CLI checkpoint with ±1 tables, carried
    into the port's workspace -> (data, jax ws, port ws)."""
    from conftest import make_toy_dataset

    data = str(root / "data")
    make_toy_dataset(root / "data", H=32, W=32)
    jws, tws = str(root / "jws"), str(root / "tws")
    jcfg = jcli.build_config([data, "--workspace", jws] + FLAGS)
    _, occ, _, params = jcli._build_world(jcfg, JDataset(jcfg))
    rng = np.random.default_rng(0)
    inner = dict(params["params"])
    for k in sorted(inner):
        if k.startswith("encoder_"):
            inner[k] = jnp.asarray(
                rng.uniform(-1, 1, inner[k].shape).astype(np.float32))
    params = {**params, "params": inner}
    tx = build_optimizer(jcfg.lr, jcfg.lr_net, jcfg.iters)
    JTrainer(jws).save_checkpoint(JState.create(params, tx), occ)
    _carry(jws, data, tws)
    return data, jws, tws


def _recording(monkeypatch, mod, vols, key):
    """mod.extract_geometry, with the densities it queried kept in
    vols[key]."""
    orig = mod.extract_geometry

    def wrapped(*a, **kw):
        q, got = kw["query_func"], []

        def query(p):
            out = np.asarray(q(p))
            got.append(out)
            return out

        out = orig(*a, **{**kw, "query_func": query})
        vols[key] = np.concatenate(got)
        vols[key + " args"] = (a, kw)
        return out

    monkeypatch.setattr(mod, "extract_geometry", wrapped)


def test_save_mesh_matches_jax(tmp_path, monkeypatch):
    data, jws, tws = _workspace(tmp_path)
    vols = {}
    _recording(monkeypatch, jmesh, vols, "jax")
    _recording(monkeypatch, tmesh, vols, "port")
    # the densities at the Config's threshold (no surface: the field sits
    # near 1), then the mesh at their median
    jcli.run_save_mesh(jcli.build_config([data, "--workspace", jws]
                                         + FLAGS))
    thr = float(np.median(vols["jax"]))
    more = ["--mesh_threshold", repr(thr)]
    jcli.run_save_mesh(jcli.build_config([data, "--workspace", jws]
                                         + FLAGS + more))
    got = cli.run_save_mesh(*cli.parse_args(
        [data, "--workspace", tws, "--device", "cpu"] + FLAGS + more))
    j, t = vols["jax"], vols["port"]
    assert t.shape == j.shape == (RES ** 3,)
    np.testing.assert_allclose(t, j, rtol=SIGMA_RTOL, atol=0)
    assert np.mean(t == j) >= EQUAL_MIN, np.mean(t == j)

    # the float32 field falls outside
    cli.run_save_mesh(*cli.parse_args(
        [data, "--workspace", tws, "--device", "cpu", "--fp16", "0"]
        + FLAGS + more))
    assert np.mean(vols["port"] == j) < EQUAL_F32_MAX

    ply = os.path.join(jws, "meshes", "mesh_0.ply")
    assert got["path"] == os.path.join(tws, "meshes", "mesh_0.ply")
    assert got["step"] == 0 and got["query_seconds"] >= 0
    a, kw = vols["jax args"]       # one chunk of queries at RES = 24
    v, f = tmesh.extract_geometry(*a, **{**kw, "query_func": lambda p: j})
    tmesh.save_ply(str(tmp_path / "from_jax.ply"), v, f)
    with open(ply, "rb") as fa, open(tmp_path / "from_jax.ply", "rb") as fb:
        assert fa.read() == fb.read()
    jverts = len(v)
    assert jverts > 1000
    assert abs(got["verts"] - jverts) <= 0.01 * jverts
    with open(got["path"], "rb") as fp:
        assert fp.read().startswith(b"ply\n")


def test_save_mesh_needs_the_card_unless_asked(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run_save_mesh(*cli.parse_args(
            [str(tmp_path), "--workspace", str(tmp_path / "ws")] + FLAGS))
