"""The port's CLI (lzzx_nerf_tpu_torch/cli.py) on the CPU: its flags
against the JAX CLI's, its refusals, the ported flags (--encoder hash)
trained, tested and meshed, the training run's files and step
schedule, a resumed run against an unbroken one, the lips and torso
stages, the workspace served by InferenceSession and the HTTP API, the
train_camera step against JAX's, and the checkpoint carried between the
packages.

Fixture: the synthetic oracle written as a 32² dataset of 8 frames
(tools/dataset.py), grid 32, S 16, 1,024 rays a step (the compacted
budget 1,024), the grid refreshed every 4 steps. The training runs are
the port's own (the JAX CLI trains its own seeded field); the rendering
parity of --test with JAX is tests/test_torch_cli_test.py.

Tolerances: a resumed run's parameters, EMA, moments and occupancy equal
an unbroken run's bit for bit (same device, same draws); the train_camera
step at tests/test_torch_train_step.py's tolerances; the carried
checkpoint's leaves equal."""

import dataclasses
import json
import os
import pickle
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lzzx_nerf_tpu import cli as jcli
from lzzx_nerf_tpu.train import TrainState as JState
from lzzx_nerf_tpu.train import Trainer as JTrainer
from lzzx_nerf_tpu.train import build_optimizer
from lzzx_nerf_tpu.train import make_train_step as j_make_step
from lzzx_nerf_tpu_torch import cli
from lzzx_nerf_tpu_torch.config import Config
from lzzx_nerf_tpu_torch.models import NeRFField
from lzzx_nerf_tpu_torch.serving import InferenceSession
from lzzx_nerf_tpu_torch.serving.state_io import (checkpoint_from_jax,
                                                  checkpoint_steps,
                                                  checkpoint_to_jax,
                                                  params_from_jax,
                                                  read_checkpoint)
from lzzx_nerf_tpu_torch.serving.webapi import serve
from lzzx_nerf_tpu_torch.tools.dataset import write_synthetic_dataset
from lzzx_nerf_tpu_torch.train import HeadOptimizer, TrainState
from lzzx_nerf_tpu_torch.train.trainer import Trainer, make_train_step
from test_torch_threads import _one_thread  # noqa: F401  (autouse)
from test_torch_train_step import (ITERS, LOSS_RTOL, N_RAYS, S,
                                   _assert_grad_close, _jax_draws, _tbatch,
                                   _tdraws, world)  # noqa: F401

FIXTURE_NPZ = os.path.join(os.path.dirname(__file__), "fixtures",
                           "lpips_fixture.npz")
ITERS_CLI = 24


def _args(data, ws, *more):
    return [data, "--workspace", ws, "--asr_model", "deepspeech",
            "--grid_size", "32", "--num_rays", "1024",
            "--train_budget_frac", "1.0", "--train_compact_warmup", "12",
            "--update_extra_interval", "4", "--eval_interval", "2",
            "--eval_frames", "1", "--device", "cpu", *more]


def _quiet(*a):
    pass


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    data = write_synthetic_dataset(str(root / "oracle"), res=32, frames=8,
                                   val=2)["data"]
    return str(root), data


@pytest.fixture(scope="module")
def trained(oracle):
    """An unbroken head run, the same run stopped after one epoch and
    resumed, a lips finetune after it and a torso stage."""
    root, data = oracle
    ws_a = os.path.join(root, "trial_oracle")
    ws_b = os.path.join(root, "resumed")
    full = cli.run_train(*cli.parse_args(_args(
        data, ws_a, "--iters", str(ITERS_CLI), "--max_keep_ckpt", "2")))
    part = cli.run_train(*cli.parse_args(_args(
        data, ws_b, "--iters", str(ITERS_CLI))), stop_after=8)
    rest = cli.run_train(*cli.parse_args(_args(
        data, ws_b, "--iters", str(ITERS_CLI))))
    torso = cli.run_train(*cli.parse_args(_args(
        data, ws_a + "_torso", "--torso", "1", "--iters", "16")))
    return dict(root=root, data=data, ws=ws_a, ws_b=ws_b, full=full,
                part=part, rest=rest, torso=torso)


@pytest.mark.parametrize("argv", [
    ["data/x", "-O"],
    ["data/x", "--cuda_ray", "--iters", "5", "--bound", "2"],
    ["data/x", "--cuda_ray", "1", "--data_range", "0", "5", "--fix_eye",
     "0.25"],
    ["data/x", "--cuda_r=0", "--torso", "1", "--workspace", "w"],
    ["data/x", "--finetune_lips", "1", "--infer_march_group", "1"],
], ids=["O", "cuda_ray", "cuda_ray_1", "prefix", "lips"])
def test_flags_parse_as_the_jax_cli(argv):
    want = dataclasses.asdict(jcli.build_config(argv))
    got = dataclasses.asdict(cli.build_config(argv))
    assert got == want
    assert cli.parse_args(argv + ["--device", "cpu"])[1] == "cpu"


@pytest.mark.parametrize("flag,item", [
    (["--data_parallel", "2"], "item 7"), (["--patch_size", "4"], "item 5"),
    (["--train_stage_split", "4"], "item 5"), (["--emb", "1"], "item 8"),
    (["--exp_eye", "0"], "item 8"),
    (["--test", "1", "--infer_data_parallel", "2"], "item 7"),
    (["--test", "1", "--infer_table_bf16", "0"], "item 8"),
], ids=lambda v: v if isinstance(v, str) else v[0])
def test_refusals_name_their_roadmap_item(tmp_path, flag, item):
    argv = [str(tmp_path), "--workspace", str(tmp_path / "ws"),
            "--device", "cpu", *flag]
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 {item}"):
        cli.main(argv)


@pytest.mark.parametrize("flag", [["--encoder", "hash"]],
                         ids=lambda v: v[0])
def test_ported_flags_train_test_and_mesh(oracle, tmp_path, flag):
    """The flags the CLI refused before their paths were ported train the
    head and the torso, render --test --torso and mesh: --encoder hash
    (the hash head, the tiled torso)."""
    _, data = oracle
    ws = str(tmp_path / "ws")
    cli.main(_args(data, ws, "--iters", "8", *flag))
    cli.main(_args(data, ws + "_torso", "--torso", "1", "--iters", "8",
                   *flag))
    head = read_checkpoint(os.path.join(ws, "checkpoints"))
    torso = read_checkpoint(os.path.join(ws + "_torso", "checkpoints"))
    assert int(head["state"]["step"]) == int(torso["state"]["step"]) == 8
    assert head["state"]["ema_params"]["encoder_xy"].shape == (163_584, 1)
    assert torso["state"]["ema_params"]["torso_encoder"].shape == (
        555_520, 2)
    common = [data, "--workspace", ws, "--asr_model", "deepspeech",
              "--grid_size", "32", "--device", "cpu", *flag]
    cli.main(common + ["--test", "1", "--test_train", "1", "--torso", "1"])
    pngs = [f for f in os.listdir(os.path.join(ws, "results"))
            if f.endswith(".png")]
    assert len(pngs) == 8
    cli.main(common + ["--save_mesh", "1", "--mesh_resolution", "24"])
    assert os.listdir(os.path.join(ws, "meshes")) == ["mesh_8.ply"]


def test_no_gpu_raises_without_device_cpu(tmp_path):
    """The default device is the GPU: without one (and without --device
    cpu) the CLI raises before it reads anything; it never falls back."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    for more in ([], ["--test", "1"], ["--save_mesh", "1"], ["--asr", "1"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([str(tmp_path), "--workspace", str(tmp_path / "w"),
                      *more])


def test_training_run_writes_its_files_and_schedule(trained):
    ws = trained["ws"]
    with open(os.path.join(ws, "opt.txt")) as f:
        opts = [json.loads(ln) for ln in f if ln.strip()]
    assert opts[-1]["iters"] == ITERS_CLI and opts[-1]["grid_size"] == 32
    log = open(os.path.join(ws, "log_ngp.txt")).read()
    assert "[INFO] 8 train frames, res 32x32" in log
    assert "[INFO] training done" in log
    assert log.count("[eval] epoch") == 1 and "PSNR = " in log
    # one checkpoint an epoch, the newest max_keep_ckpt kept
    assert checkpoint_steps(os.path.join(ws, "checkpoints")) == [16, 24]
    assert sorted(os.listdir(os.path.join(ws, "validation"))) == [
        "ep0002_0.png"]
    sched = trained["full"]["schedule"]
    assert [it for it, _, _ in sched] == list(range(ITERS_CLI))
    assert [k for _, k, _ in sched] == ["full"] * 12 + ["compact"] * 12
    assert [r for _, _, r in sched] == [it % 4 == 0
                                        for it in range(ITERS_CLI)]
    # the torso stage trains into its own workspace
    tws = ws + "_torso"
    assert checkpoint_steps(os.path.join(tws, "checkpoints")) == [8, 16]
    assert "[INFO] torso training done" in open(
        os.path.join(tws, "log_ngp.txt")).read()


def test_resumed_run_continues_as_the_unbroken_one(trained):
    """A run stopped after one epoch and resumed makes the unbroken run's
    steps with its draws: every saved leaf of the last checkpoint is
    equal, and the resumed schedule is the unbroken one's tail."""
    part, rest = trained["part"], trained["rest"]
    assert [it for it, _, _ in part["schedule"]] == list(range(8))
    assert rest["schedule"] == trained["full"]["schedule"][8:]
    assert "[INFO] resumed at step 8" in open(
        os.path.join(trained["ws_b"], "log_ngp.txt")).read()
    a = read_checkpoint(os.path.join(trained["ws"], "checkpoints"), 24)
    b = read_checkpoint(os.path.join(trained["ws_b"], "checkpoints"), 24)

    def leaves(ck):
        st = ck["state"]
        flat = {}
        for name, tree in (("params", st["params"]["params"]),
                           ("ema", st["ema_params"]),
                           ("nu", st["opt_state"]["nu"])):
            flat.update({f"{name}/{k}": v
                         for k, v in params_from_jax(tree).items()})
        flat.update({f"occ/{k}": torch.as_tensor(v)
                     for k, v in ck["occ"].items()})
        return flat

    la, lb = leaves(a), leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert torch.equal(la[k], lb[k]), k
    assert int(a["state"]["step"]) == int(b["state"]["step"]) == 24
    np.testing.assert_array_equal(a["generator"]["state"],
                                  b["generator"]["state"])


def test_lips_finetune_alternates_and_guards_its_lpips(oracle, trained,
                                                       monkeypatch):
    root, data = oracle
    ws = trained["ws_b"]
    argv = _args(data, ws, "--iters", str(ITERS_CLI + 8), "--finetune_lips",
                 "1", "--lips_crop", "32")
    from lzzx_nerf_tpu_torch.train import lpips as lpips_mod

    monkeypatch.delenv("LZZX_LPIPS_NPZ", raising=False)
    monkeypatch.setattr(lpips_mod, "DEFAULT_WEIGHTS",
                        os.path.join(root, "no_such.npz"))
    with pytest.raises(SystemExit, match="--allow_rand_lpips"):
        cli.run_train(*cli.parse_args(argv))
    monkeypatch.setenv("LZZX_LPIPS_NPZ", FIXTURE_NPZ)
    out = cli.run_train(*cli.parse_args(argv))
    assert [(it, k) for it, k, _ in out["schedule"]] == [
        (it, "lips" if it % 2 else "compact")
        for it in range(ITERS_CLI, ITERS_CLI + 8)]
    log = open(os.path.join(ws, "log_ngp.txt")).read()
    assert f"LPIPS weights: pretrained ({FIXTURE_NPZ})" in log


def test_cli_workspace_serves(trained, tmp_path):
    """InferenceSession reads the CLI's newest checkpoint and its _torso
    workspace (no production_state.pkl); the HTTP API serves the same
    workspace and writes the session's bytes."""
    root, data, ws = trained["root"], trained["data"], trained["ws"]
    cfg = Config(asr_model="deepspeech", grid_size=32, budget_frac=1.0)
    s = InferenceSession(cfg, device="cpu", log=_quiet)
    s.load_model(data, ws)
    assert s.torso is not None
    ck = read_checkpoint(os.path.join(ws, "checkpoints"))
    ema = params_from_jax(ck["state"]["ema_params"])
    for n, p in s.field.named_parameters():
        assert torch.equal(p.detach(), ema[n]), n
    feats = np.load(os.path.join(data, "aud_ds.npy"))[:4]
    got = {}
    s.set_audio_features(feats)
    s.run(on_frame=lambda i, b: got.__setitem__(i, b))
    assert sorted(got) == list(range(4))
    want = b"".join(got[i].tobytes() for i in range(4))

    raw = tmp_path / "out.raw"
    httpd = serve(cfg, host="127.0.0.1", port=0, data_root=root,
                  trial_root=root, device="cpu", sink_kind="raw",
                  out_path=str(raw))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(route, body):
        req = urllib.request.Request(base + route, json.dumps(body).encode(),
                                     {"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            return {"http": e.code, **json.loads(e.read())}

    try:
        r = post("/api/model_select", {"model": "oracle"})
        assert r["model"] == "oracle" and r["frames"] == 8, r
        npy = os.path.join(root, "utterance.npy")
        np.save(npy, feats)
        assert post("/api/audio_upload", {"aud_path": npy})[
            "aud_frames"] == 4
        with urllib.request.urlopen(base + "/api/inference?wait=1") as r:
            res = json.loads(r.read())
        assert res["done"] and res["error"] is None, res
        assert raw.read_bytes() == want
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)


def test_train_camera_step_matches_jax(world):  # noqa: F811
    """One train_camera step (the rays moved by the frame's learned
    refinement): the loss and every gradient against JAX's
    make_train_step(train_camera=True) on the same draws, at
    tests/test_torch_train_step.py's tolerances, except camera_dR and
    camera_dT. Those collect a sum over the 1,024 rays whose terms
    cancel, and JAX's jitted step, the same loss jitted alone and the
    same loss evaluated op by op give them values up to 7 % apart
    (float32 rounding under XLA's fusions). They are held, at the same
    tolerances, to JAX's gradient of the step's own loss (render_rays,
    head_losses, the refinement) evaluated op by op on the same draws."""
    from lzzx_nerf_tpu.render.renderer import render_rays as j_render
    from lzzx_nerf_tpu.train.losses import head_losses as j_losses
    from lzzx_nerf_tpu.utils.pose import euler_angles_to_matrix as j_euler

    w = world
    rng = np.random.default_rng(21)
    # tables drawn in ±0.1 (not the ±1e-4 init): the gradient a ray's
    # origin and direction receive comes through the lookup
    params = {"params": {
        k: (jnp.asarray(rng.uniform(-0.1, 0.1, v.shape).astype(np.float32))
            if k.startswith("encoder_") else v)
        for k, v in w["params"]["params"].items()}}
    params["params"]["camera_dR"] = jnp.asarray(
        rng.normal(0, 2.0, (64, 3)).astype(np.float32))
    params["params"]["camera_dT"] = jnp.asarray(
        rng.normal(0, 0.02, (64, 3)).astype(np.float32))
    tx = w["tx"]
    step = jax.jit(j_make_step(w["field"], w["jrs"], tx, train_camera=True,
                               **w["common"]))
    key = jax.random.PRNGKey(5)
    jb = {k: jnp.asarray(v) for k, v in w["batch"].items()}
    js, jm = step(JState.create(params, tx).replace(
        step=jnp.asarray(1, jnp.int32)), w["jocc"], jb, key)
    jgrads = params_from_jax(jax.tree.map(np.asarray, js.opt_state[0]))
    draws = _jax_draws(key, 1, N_RAYS * S)

    tf = NeRFField(audio_in_dim=w["ds"].audio_dim, ind_num=64,
                   camera_frames=64)
    tf.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    st = TrainState.create(tf, HeadOptimizer(tf.named_parameters(), 1e-2,
                                             1e-3, ITERS))
    st.step = 1
    fn = make_train_step(tf, w["trs"], train_camera=True, **w["common"])
    m = fn(st, w["tocc"], _tbatch(w["batch"]), draws=_tdraws(draws))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    named = dict(tf.named_parameters())
    for name, p in named.items():
        if not name.startswith("camera_"):
            _assert_grad_close(p.grad.numpy(), jgrads[name].numpy(), name)

    # the step's loss as a function of frame 0's refinement, op by op
    b = w["batch"]
    inds = np.asarray(draws["inds"])
    ray_inds = torch.from_numpy(inds.astype(np.int64))
    from lzzx_nerf_tpu_torch.utils import get_rays as t_get_rays
    rays = t_get_rays(torch.as_tensor(b["pose"])[None], w["ds"].intrinsics,
                      48, 48, inds=ray_inds)
    ro, rd = (jnp.asarray(rays[k][0].numpy()) for k in ("rays_o", "rays_d"))
    eye = jnp.asarray(b["eye"]) + (jnp.asarray(draws["eye_jitter"])
                                   - 0.5) / 10
    gt = jnp.asarray(b["image"].reshape(-1, 3)[inds])
    face = jnp.asarray(b["face_mask"].reshape(-1)[inds])
    bg = jnp.asarray(b["bg_color"].reshape(-1, 3)[inds])

    def loss(cam_r, cam_t):
        p = params
        enc = w["field"].apply(p, jnp.asarray(b["auds"]),
                               method="encode_audio")
        dr = j_euler(cam_r / 180.0 * jnp.pi + 1e-8)
        res = j_render(w["field"].apply, p, w["jrs"], w["jocc"], ro + cam_t,
                       rd @ dr, enc, p["params"]["individual_codes"][0],
                       eye, bg, noise=jnp.asarray(draws["noise"]),
                       training=True)
        return j_losses(res, res["image"], gt, face, 1.0 / ITERS,
                        max_steps=S)

    gr, gt_ = jax.grad(loss, argnums=(0, 1))(
        params["params"]["camera_dR"][0], params["params"]["camera_dT"][0])
    for name, ref in (("camera_dR", gr), ("camera_dT", gt_)):
        got = named[name].grad.numpy()
        assert np.all(got[1:] == 0), name
        assert np.abs(np.asarray(ref)).max() > 0, name
        _assert_grad_close(got[0], np.asarray(ref), name)
    # the camera group: constant lr 1e-5, no weight decay
    assert st.opt.groups["camera"]["names"] == ["camera_dR", "camera_dT"]


def test_checkpoint_carried_between_packages(world, tmp_path):  # noqa: F811
    """A JAX CLI checkpoint (orbax, through JAX's Trainer) becomes the
    port's, restores into the port's TrainState, and goes back into JAX's
    TrainState with every leaf equal."""
    w = world
    tx = build_optimizer(1e-2, 1e-3, ITERS)
    state = JState.create(w["params"], tx)
    rng = np.random.default_rng(3)

    def fill(x):
        x = np.asarray(x)
        if x.dtype == np.float32 and x.ndim:
            return jnp.asarray(rng.uniform(0, 1, x.shape).astype(np.float32))
        return jnp.asarray(x)

    state = state.replace(
        opt_state=jax.tree.map(fill, state.opt_state),
        ema_params=jax.tree.map(fill, state.ema_params),
        step=jnp.asarray(7, jnp.int32))
    count = jnp.asarray(7, jnp.int32)
    state = state.replace(opt_state=jax.tree.map(
        lambda x: count if (np.asarray(x).dtype == np.int32
                            and not np.ndim(x)) else x, state.opt_state))
    JTrainer(str(tmp_path / "jws")).save_checkpoint(state, w["jocc"])
    got, jocc, ok = JTrainer(str(tmp_path / "jws")).load_checkpoint(
        JState.create(w["params"], tx), w["jocc"])
    assert ok
    jck = {"state": jax.tree.map(np.asarray, got),
           "occ": {k: np.asarray(v) for k, v in jocc._asdict().items()}}
    ck = checkpoint_from_jax(jck)

    tf = NeRFField(audio_in_dim=w["ds"].audio_dim, ind_num=64)
    st = TrainState.create(tf, HeadOptimizer(tf.named_parameters(), 1e-2,
                                             1e-3, ITERS))
    port_ws = tmp_path / "tws"
    os.makedirs(port_ws / "checkpoints")
    with open(port_ws / "checkpoints" / "ckpt_00000007.pkl", "wb") as f:
        pickle.dump(ck, f)
    st, occ, ok = Trainer(str(port_ws)).load_checkpoint(st, w["tocc"])
    assert ok and st.step == 7 and int(st.opt.count) == 7
    jp = params_from_jax(jck["state"].params)
    for n, p in tf.named_parameters():
        assert torch.equal(p.detach(), jp[n]), n
    je = params_from_jax(jck["state"].ema_params)
    for n, e in st.ema.items():
        assert torch.equal(e, je[n]), n

    # and back: the port's own checkpoint of this state into JAX's tree
    path = Trainer(str(port_ws)).save_checkpoint(st, occ)
    with open(path, "rb") as f:
        back = checkpoint_to_jax(pickle.load(f), {
            "state": JState.create(w["params"], tx),
            "occ": w["jocc"]._asdict()})
    want = jax.tree_util.tree_leaves_with_path(jck["state"])
    have = dict(jax.tree_util.tree_leaves_with_path(back["state"]))
    assert len(want) == len(have)
    for path, leaf in want:
        if "mu" in jax.tree_util.keystr(path):
            continue   # first moments are not kept (b1 = 0)
        np.testing.assert_array_equal(np.asarray(have[path]),
                                      np.asarray(leaf),
                                      jax.tree_util.keystr(path))
