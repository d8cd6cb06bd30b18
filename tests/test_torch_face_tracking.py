"""The port's 3DMM tracker (lzzx_nerf_tpu_torch/preprocess/face_tracking.py)
against the JAX package's on the CPU, on tests/test_face_tracking.py's
synthetic morphable models (_synthetic_model, its texture variant and
_two_layer_model), carried into the port by state_io.face3dmm_from_jax /
track_params_from_jax.

Tolerances:
- geometry (euler2rot, forward_transform, geometry, albedo, the inner
  landmarks, vertex normals, SH irradiance): rtol 1e-5 / atol 1e-5 of the
  values' scale (float32, other summation orders);
- contour snapping: the chosen candidate index equal at the same inputs
  (the synthetic contour sets are random far-apart points, so a changed
  index would move a landmark by a large step);
- the point-splat render and its gradients: atol 1e-5 on images in
  [0, 1], rtol 1e-5 / atol 1e-5 on wsum, gradients within 1e-4 in
  relative L2 norm (scatter-adds summed in another order);
- Adam: OptaxAdam against optax.adam on the same gradients over 1 and
  20 steps with the 0.2 post-scale decay: rtol 1e-6; the landmark loop
  (_adam_fit) over 1 and 20 steps: atol 1e-5;
- short fits: fit_coarse's euler / trans within 1e-4, fit_light's 20
  steps within 1e-3 of JAX's tex / gamma (two float32 optimisations from
  the same start);
- whole fits by their outcome: test_face_tracking.py's thresholds (inner
  reprojection error < 2 px and translation error < 0.35 for the coarse
  fit; photometric loss < 5e-4 and < 1e-3 for fit_light; the fine fit with
  the photometric term lowers the reprojection error); track_video on the
  stand-in clip of tools/synthetic_face.py (the focal search cut to one
  focal): both packages' written poses recover the ground truth at those
  thresholds, and agree within 1e-2 (observed 4.7e-3 in euler, 4.1e-3 in
  trans after the coarse, light and fine stages).
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import lzzx_nerf_tpu.preprocess.face_tracking as J
import lzzx_nerf_tpu_torch.preprocess.face_tracking as T
from lzzx_nerf_tpu_torch.serving.state_io import (face3dmm_from_jax,
                                                  track_params_from_jax)
from test_face_tracking import _photo_params, _synthetic_model, \
    _two_layer_model
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

CXY = (64.0, 64.0)


def _port(model):
    return face3dmm_from_jax({f.name: getattr(model, f.name)
                              for f in dataclasses.fields(model)})


def _tp(params):
    return track_params_from_jax(
        {k: np.asarray(v) for k, v in params.items()})


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, rtol=1e-5, atol_rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(_np(got), want, rtol=rtol,
                               atol=atol_rel * max(np.abs(want).max(), 1e-30))


def _pose_case(F=6, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.15, 0.15, (F, 3)).astype(np.float32),
            (rng.uniform(-0.3, 0.3, (F, 3)) + [0, 0, -7.0]).astype(
                np.float32))


def test_geometry_helpers_match_jax():
    e, t = _pose_case()
    _close(T.euler2rot(torch.from_numpy(e)), J.euler2rot(jnp.asarray(e)))
    g = np.random.default_rng(2).uniform(-1, 1, (6, 40, 3)).astype(
        np.float32)
    _close(T.forward_transform(torch.from_numpy(g), torch.from_numpy(e),
                               torch.from_numpy(t), torch.tensor(900.0),
                               (256.0, 256.0)),
           J.forward_transform(jnp.asarray(g), jnp.asarray(e),
                               jnp.asarray(t), jnp.float32(900.0),
                               (256.0, 256.0)))
    for F in (5, 2):
        x = np.random.default_rng(F).normal(size=(F, 7)).astype(np.float32)
        _close(T.lap_loss_1d(torch.from_numpy(x)),
               J.lap_loss_1d(jnp.asarray(x)))


@pytest.mark.parametrize("texture", [False, True], ids=["plain", "texture"])
def test_model_and_landmarks_match_jax(texture):
    jm = _synthetic_model(texture=texture)
    tm = _port(jm)
    F = 6
    e, t = _pose_case(F)
    rng = np.random.default_rng(3)
    idp = rng.normal(0, 1, (F, 8)).astype(np.float32)
    expp = rng.normal(0, 1, (F, 6)).astype(np.float32)
    _close(tm.geometry(torch.from_numpy(idp), torch.from_numpy(expp)),
           jm.geometry(jnp.asarray(idp), jnp.asarray(expp)))
    if texture:
        tex = rng.uniform(-1, 1, (1, 4)).astype(np.float32)
        _close(tm.albedo(torch.from_numpy(tex)), jm.albedo(jnp.asarray(tex)))
    args_t = (torch.from_numpy(idp), torch.from_numpy(expp),
              torch.from_numpy(e), torch.from_numpy(t), torch.tensor(900.0),
              (256.0, 256.0))
    args_j = (jnp.asarray(idp), jnp.asarray(expp), jnp.asarray(e),
              jnp.asarray(t), jnp.float32(900.0), (256.0, 256.0))
    lt = _np(tm.landmarks_3d(*args_t))
    lj = np.asarray(jm.landmarks_3d(*args_j))
    # the inner landmarks tightly
    _close(lt[:, 17:], lj[:, 17:])
    _close(lt[:, 8], lj[:, 8])

    # the snapped ones by the candidate each package picks
    def picks(mod, model, cset, take_max):
        idp_, expp_, e_, t_, f_, cxy = (args_t if mod is T else args_j)
        sel = np.asarray(cset).reshape(-1)
        full = model.geometry(idp_, expp_)
        g = full[:, sel]
        px = np.asarray(_np(mod.forward_transform(g, e_, t_, f_, cxy)))
        px = px[..., 0].reshape(F, 8, -1)
        return (px.argmax(2) if take_max else px.argmin(2))

    for cset, mx, sl in ((jm.left_contour, False, slice(0, 8)),
                         (jm.right_contour, True, slice(9, 17))):
        it = picks(T, tm, cset, mx)
        ij = picks(J, jm, cset, mx)
        np.testing.assert_array_equal(it, ij)
        _close(lt[:, sl], lj[:, sl])


@pytest.mark.parametrize("which", ["texture", "two_layer"])
def test_photometric_render_matches_jax(which):
    jm = (_synthetic_model(texture=True) if which == "texture"
          else _two_layer_model())
    tm = _port(jm)
    p = _photo_params(jm, 2, np.random.default_rng(3))
    tp = _tp(p)
    verts_j = jm.geometry(jnp.zeros((2, 8)), p["exp"])
    verts_t = tm.geometry(torch.zeros((2, 8)), tp["exp"])
    nj = J.vertex_normals(verts_j, jm.tris)
    nt = T.vertex_normals(verts_t, tm.tris)
    _close(nt, nj)
    _close(T.sh_irradiance(nt, tp["gamma"]),
           J.sh_irradiance(nj, p["gamma"]))
    for tau in (0.05, 0.0):
        it, wt = T.render_photometric(tm, tp, CXY, 128, 128, scale=0.5,
                                      depth_tau_rel=tau)
        ij, wj = J.render_photometric(jm, p, CXY, 128, 128, scale=0.5,
                                      depth_tau_rel=tau)
        np.testing.assert_allclose(_np(it), np.asarray(ij), atol=1e-5)
        np.testing.assert_allclose(_np(wt), np.asarray(wj), rtol=1e-5,
                                   atol=1e-5)


def test_splat_occlusion_and_gradients_match_jax():
    """The soft z-buffer on test_face_tracking.py's two co-projected
    sheets, and the gradient of a photometric loss with respect to the
    pose, texture and light through the splat."""
    n = 400
    rng = np.random.default_rng(0)
    xy = rng.uniform(10, 22, (n, 2)).astype(np.float32)
    proj = np.tile(xy, (2, 1))[None]
    colors = np.concatenate([np.tile([[1.0, 0.0, 0.0]], (n, 1)),
                             np.tile([[0.0, 1.0, 0.0]], (n, 1))])[None]
    depth = np.concatenate([np.full(n, 5.0), np.full(n, 6.0)])[None]
    f32 = [np.asarray(a, np.float32) for a in (proj, colors, depth)]
    it, wt = T.splat_render(*(torch.from_numpy(a) for a in f32[:2]),
                            torch.ones(1, 2 * n), 32, 32,
                            depth=torch.from_numpy(f32[2]),
                            depth_tau=torch.tensor(0.05))
    ij, wj = J.splat_render(*(jnp.asarray(a) for a in f32[:2]),
                            jnp.ones((1, 2 * n)), 32, 32,
                            depth=jnp.asarray(f32[2]),
                            depth_tau=jnp.asarray(0.05))
    np.testing.assert_allclose(_np(it), np.asarray(ij), atol=1e-5)
    np.testing.assert_allclose(_np(wt), np.asarray(wj), rtol=1e-5)

    jm = _two_layer_model()
    tm = _port(jm)
    p = _photo_params(jm, 2, np.random.default_rng(6))
    target = np.random.default_rng(7).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    keys = ("euler", "trans", "tex", "gamma")

    def j_loss(q):
        img, wsum = J.render_photometric(jm, {**p, **q}, CXY, 128, 128, 0.5)
        return jnp.sum((img - target) ** 2 * (wsum > 0.5)[..., None])

    jg = jax.jit(jax.grad(j_loss))({k: p[k] for k in keys})
    tp = _tp(p)
    leaves = {k: tp[k].clone().requires_grad_() for k in keys}
    img, wsum = T.render_photometric(tm, {**tp, **leaves}, CXY, 128, 128,
                                     0.5)
    loss = torch.sum((img - torch.from_numpy(target)) ** 2
                     * (wsum > 0.5)[..., None])
    tg = torch.autograd.grad(loss, [leaves[k] for k in keys])
    for k, g in zip(keys, tg):
        ref = np.asarray(jg[k])
        err = np.linalg.norm(_np(g) - ref) / np.linalg.norm(ref)
        assert err < 1e-4, (k, err)


@pytest.mark.parametrize("steps", [1, 20])
def test_adam_matches_optax(steps):
    """OptaxAdam on the same gradient sequence as optax.adam, with the
    landmark loop's post-scale (x 0.2 at every 5th step)."""
    rng = np.random.default_rng(steps)
    shapes = [(1, 8), (6, 3)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) * 10.0 ** rng.uniform(
        -6, 1) for s in shapes] for _ in range(steps)]
    tx = optax.adam(0.1)
    jp = [jnp.asarray(a) for a in p0]
    state = tx.init(jp)
    adam = T.OptaxAdam(0.1, [torch.from_numpy(a) for a in p0])
    tp = [torch.from_numpy(a.copy()) for a in p0]
    scale_j, scale_t = jnp.float32(1.0), torch.ones(())
    for i, g in enumerate(grads):
        if i and i % 5 == 0:
            scale_j, scale_t = scale_j * 0.2, scale_t * 0.2
        u, state = jax.jit(tx.update)([jnp.asarray(x) for x in g], state)
        jp = optax.apply_updates(jp, [x * scale_j for x in u])
        ut = adam.update([torch.from_numpy(x) for x in g])
        tp = [a + b * scale_t for a, b in zip(tp, ut)]
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def _coarse_case():
    jm = _synthetic_model()
    F = 6
    e, t = _pose_case(F)
    cxy = (256.0, 256.0)
    lands = jm.landmarks_3d(jnp.zeros((F, 8)), jnp.zeros((F, 6)),
                            jnp.asarray(e), jnp.asarray(t),
                            jnp.float32(900.0), cxy)
    gt = np.asarray(J.forward_transform(lands, jnp.asarray(e),
                                        jnp.asarray(t), jnp.float32(900.0),
                                        cxy)[..., :2])
    return jm, _port(jm), gt, e, t, cxy


@pytest.mark.parametrize("iters", [1, 20])
def test_landmark_adam_loop_matches_jax(iters):
    jm, tm, gt, _, _, cxy = _coarse_case()
    trainable = ("id", "exp", "euler", "trans")
    pj, lj = J._adam_fit(jm, jnp.asarray(gt), cxy,
                         J._init_params(6, 8, 6, 900.0), trainable, iters,
                         0.1, reg_id=0.5, reg_exp=0.4, lap_w=0.05,
                         decay_at=5)
    pt, lt = T._adam_fit(tm, torch.from_numpy(gt), cxy,
                         T._init_params(6, 8, 6, 900.0, "cpu"), trainable,
                         iters, 0.1, reg_id=0.5, reg_exp=0.4, lap_w=0.05,
                         decay_at=5)
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    for k in trainable:
        np.testing.assert_allclose(_np(pt[k]), np.asarray(pj[k]), atol=1e-5)


def test_coarse_fit_matches_jax_and_recovers_pose():
    jm, tm, gt, e, t, cxy = _coarse_case()
    F = gt.shape[0]
    pt = T.fit_coarse(tm, torch.from_numpy(gt), cxy, 900.0, id_dim=8,
                      exp_dim=6)
    pj = J.fit_coarse(jm, jnp.asarray(gt), cxy, 900.0, id_dim=8, exp_dim=6)
    for k in ("euler", "trans"):
        np.testing.assert_allclose(_np(pt[k]), np.asarray(pj[k]), atol=1e-4)
    # test_face_tracking.py's recovery thresholds, on the port's own fit
    proj = T.forward_transform(
        tm.landmarks_3d(pt["id"].expand(F, 8), pt["exp"], pt["euler"],
                        pt["trans"], pt["focal"], cxy),
        pt["euler"], pt["trans"], pt["focal"], cxy)[..., :2]
    err = float(torch.sqrt(torch.mean(
        (proj[:, 17:] - torch.from_numpy(gt[:, 17:])) ** 2)))
    assert err < 2.0, err
    terr = float((pt["trans"] - torch.from_numpy(t)).abs().max())
    assert terr < 0.35, terr


@pytest.mark.parametrize("which,F,iters,bound", [
    ("texture", 3, 150, 5e-4), ("two_layer", 2, 200, 1e-3)])
def test_fit_light_recovers_target(which, F, iters, bound):
    """test_face_tracking.py's fit_light closures on the port's own fit,
    and 20 steps held against JAX's."""
    jm = (_synthetic_model(texture=True) if which == "texture"
          else _two_layer_model())
    tm = _port(jm)
    true = _photo_params(jm, F, np.random.default_rng(4 if F == 3 else 5))
    tt = _tp(true)
    frames, _ = T.render_photometric(tm, tt, CXY, 128, 128, scale=0.5)
    start = {k: v for k, v in tt.items() if k not in ("tex", "gamma")}
    out = T.fit_light(tm, frames.detach(), CXY, dict(start), scale=0.5,
                      iters=iters, lr=0.05, reg_tex=0.0)
    assert out["photo_loss"] < bound, out["photo_loss"]

    jstart = {k: v for k, v in true.items() if k not in ("tex", "gamma")}
    jframes = jnp.asarray(_np(frames))
    jo = J.fit_light(jm, jframes, CXY, dict(jstart), scale=0.5, iters=20,
                     lr=0.05)
    to = T.fit_light(tm, frames.detach(), CXY, dict(start), scale=0.5,
                     iters=20, lr=0.05)
    for k in ("tex", "gamma"):
        np.testing.assert_allclose(_np(to[k]), np.asarray(jo[k]), atol=1e-3)
    np.testing.assert_allclose(to["photo_loss"], jo["photo_loss"],
                               rtol=1e-3)


def test_fine_fit_with_photometric_term_improves_pose():
    jm = _synthetic_model(texture=True)
    tm = _port(jm)
    F = 2
    true = _tp(_photo_params(jm, F, np.random.default_rng(5)))
    frames, _ = T.render_photometric(tm, true, CXY, 128, 128, scale=0.5)
    lands = tm.landmarks_3d(true["id"].expand(F, 8), true["exp"],
                            true["euler"], true["trans"], true["focal"], CXY)
    gt = T.forward_transform(lands, true["euler"], true["trans"],
                             true["focal"], CXY)[..., :2]
    start = dict(true)
    start["euler"] = true["euler"] + 0.02
    start["trans"] = true["trans"] + torch.tensor([0.05, -0.05, 0.0])

    def reproj_err(p):
        lp = tm.landmarks_3d(p["id"].expand(F, 8), p["exp"], p["euler"],
                             p["trans"], p["focal"], CXY)
        pr = T.forward_transform(lp, p["euler"], p["trans"], p["focal"],
                                 CXY)[..., :2]
        return float(torch.sqrt(torch.mean((pr[:, 17:] - gt[:, 17:]) ** 2)))

    err0 = reproj_err(start)
    out = T.fit_fine(tm, gt.detach(), CXY, dict(start), iters=150,
                     lap_w=0.0, photo_frames=frames.detach(), photo_scale=0.5,
                     photo_w=0.5, save_every=150)
    assert reproj_err(out) < err0


def test_fine_fit_resume_files_read_by_both_packages(tmp_path):
    jm = _synthetic_model()
    tm = _port(jm)
    F = 5
    gt = np.random.default_rng(2).uniform(40, 210, (F, 68, 2)).astype(
        np.float32)
    cxy = (128.0, 128.0)
    start_j = {"id": jnp.zeros((1, 8)), "exp": jnp.zeros((F, 6)),
               "euler": jnp.zeros((F, 3)),
               "trans": jnp.zeros((F, 3)).at[:, 2].add(-7.0),
               "focal": jnp.float32(800.0)}
    tpath, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    T.fit_fine(tm, torch.from_numpy(gt), cxy, _tp(start_j), iters=20,
               resume_path=tpath, save_every=10)
    J.fit_fine(jm, jnp.asarray(gt), cxy, dict(start_j), iters=20,
               resume_path=jpath, save_every=10)
    with np.load(tpath) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_allclose(a[k], b[k], atol=1e-5)
    # each resumes from the other's file: the next 10 steps agree
    rt = T.fit_fine(tm, torch.from_numpy(gt), cxy, _tp(start_j), iters=10,
                    resume_path=jpath, save_every=10)
    rj = J.fit_fine(jm, jnp.asarray(gt), cxy, dict(start_j), iters=10,
                    resume_path=tpath, save_every=10)
    for k in ("exp", "euler", "trans"):
        np.testing.assert_allclose(_np(rt[k]), np.asarray(rj[k]), atol=1e-4)
    assert float(rt["focal"]) == float(rj["focal"]) == 800.0


@pytest.fixture()
def clip_dir(tmp_path):
    """The stand-in BFM assets (tools/synthetic_face.py) at a small grid
    and the BFM's coefficient widths, and 6 frames at 512²."""
    from lzzx_nerf_tpu_torch.tools import synthetic_face as sf

    sf.write_bfm_assets(str(tmp_path / "3DMM"), rows=14, cols=16,
                        contour=5)
    got = sf.write_frames(str(tmp_path / "id"), str(tmp_path / "3DMM"),
                          frames=6, res=512, device="cpu")
    return tmp_path, got


def test_track_video_matches_jax(clip_dir, monkeypatch):
    """track_video in both packages on the stand-in clip, the focal
    search cut to one focal and short loops (the full search is about
    45,000 steps); the coarse, light and fine stages at their lengths but
    fit_fine cut to 100 steps. Both write track_params.npz with the same
    keys and agree; the port also writes track_params.pt."""
    root, got = clip_dir
    for mod in (J, T):
        monkeypatch.setattr(mod, "fit_focal", functools.partial(
            mod.fit_focal, focal_range=(1100,), pose_iters=50,
            idexp_iters=50))
    for mod in (J, T):
        monkeypatch.setattr(mod, "fit_fine", functools.partial(
            mod.fit_fine, iters=100, save_every=50))
    out = {}
    stages = []
    for mod, name in ((J, "jax"), (T, "port")):
        base = root / name
        base.mkdir()
        kw = ({"device": "cpu", "log": lambda s, sec: stages.append(s)}
              if mod is T else {})
        mod.track_video(got["ori_dir"], str(base), str(root / "3DMM"), **kw)
        out[name] = dict(np.load(base / "track_params.npz"))
        assert (base / "track_iter_params.npz").exists()
    assert stages == ["focal", "coarse", "light", "fine"]
    assert sorted(out["port"]) == sorted(out["jax"])
    np.testing.assert_array_equal(out["port"]["focal"], [1100.0])
    for k in ("euler", "trans"):
        np.testing.assert_allclose(out["port"][k], out["jax"][k], atol=1e-2)
    # the outcome against the ground truth, for both packages
    gt = got["gt"]
    tm = T.Face3DMM.load(str(root / "3DMM"), device="cpu")
    cxy = (256.0, 256.0)
    lms = torch.as_tensor(np.stack([np.loadtxt(
        os.path.join(got["ori_dir"], f"{i}.lms")) for i in range(6)]),
        dtype=torch.float32)
    for name, p in out.items():
        q = {k: torch.as_tensor(v) for k, v in p.items()}
        f = q["focal"].reshape(())
        pr = T.forward_transform(
            tm.landmarks_3d(q["id"].expand(6, -1), q["exp"], q["euler"],
                            q["trans"], f, cxy),
            q["euler"], q["trans"], f, cxy)[..., :2]
        err = float(torch.sqrt(torch.mean((pr[:, 17:] - lms[:, 17:]) ** 2)))
        assert err < 2.0, (name, err)
        terr = float(np.abs(p["trans"] - gt["trans"]).max())
        assert terr < 0.35, (name, terr)
        # the same rotation (the fits may wrap an angle by 2 pi)
        rot = T.euler2rot(q["euler"]) - T.euler2rot(
            torch.as_tensor(gt["euler"], dtype=torch.float32))
        assert float(rot.abs().max()) < 0.1, name
    pt = torch.load(root / "port" / "track_params.pt")
    for k, v in out["port"].items():
        np.testing.assert_array_equal(pt[k].numpy(), v)


def test_tracker_needs_the_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.Face3DMM.load(str(tmp_path))
    with pytest.raises(RuntimeError, match="3DMM assets not found"):
        T.Face3DMM.load(str(tmp_path), device="cpu")
