"""The port's data-parallel training (parallel/, the trainer's
data_sharding, the CLI's --data_parallel) on the CPU: the head step at
world size 2 (two gloo processes started once for the module by
parallel.distributed.launch, running parallel.steps.head_steps) against
the JAX package's step on a 2-device `data` mesh; the CLI's
--data_parallel 2 over two gloo ranks it starts itself; its exit when
the GPUs are too few.

Steps (tests/test_train.py's sizes: 48², grid 32, S 8, 1,024 rays; JAX's
draws, global, handed to both ranks): the full path at step 32 (the
jitter regulariser fires, its masked MSEs over both ranks' samples), the
compacted path at steps 1 and 32 (per-shard compaction, 512 slots a
rank) and the compacted path with one 32² patch (0.1 x LPIPS on the
fixture weights, the patch split between the ranks) at step 32.
Tolerances (tests/test_train.py:131-175, :462-500): loss rtol 1e-6
(full) / 2e-5 (compacted); n_active and n_active_over equal; every
gradient to tests/test_torch_train_step.py's step rule; the parameters
after the step within 5e-3 on the tables and 1e-5 (full) / 5e-5
(compacted) elsewhere; parameters, EMA and second moments bit-equal
across the two ranks. The draws' key is 11: under key 5 one sample of
the patch case has a ReLU pre-activation of the eye attention net within
rounding of zero, and that hidden unit's 36 input weights (5.6 % of the
576-entry matrix, against the rule's 2 % exemption, which
tests/test_torch_train_step.py sized on a 2,304-entry matrix) take the
other branch in one package.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lzzx_nerf_tpu.parallel import data_sharding as j_data_sharding
from lzzx_nerf_tpu.parallel import make_mesh as j_make_mesh
from lzzx_nerf_tpu.train import TrainState as JState
from lzzx_nerf_tpu.train import lpips as jlp
from lzzx_nerf_tpu.train import make_train_step as j_make_step
from lzzx_nerf_tpu.utils import get_rays as j_get_rays
from lzzx_nerf_tpu_torch import cli
from lzzx_nerf_tpu_torch.models import NeRFField
from lzzx_nerf_tpu_torch.parallel import data_sharding, make_mesh
from lzzx_nerf_tpu_torch.parallel.distributed import launch
from lzzx_nerf_tpu_torch.parallel.steps import head_steps
from lzzx_nerf_tpu_torch.serving.state_io import (params_from_jax,
                                                  read_checkpoint)
from lzzx_nerf_tpu_torch.tools.dataset import write_synthetic_dataset
from lzzx_nerf_tpu_torch.train import make_train_step
from test_torch_threads import _one_thread  # noqa: F401  (autouse)
from test_torch_train_step import (GRID, LOSS_RTOL, N_RAYS, RES, S,
                                   _assert_grad_close, _jax_draws,
                                   world)  # noqa: F401

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "lpips_fixture.npz")
P = 32
# (name, step, make_train_step kwargs)
CASES = [("full", 32, {}),
         ("compact", 1, {"train_budget": N_RAYS}),
         ("compact", 32, {"train_budget": N_RAYS}),
         ("patch", 32, {"train_budget": N_RAYS, "patch_size": P})]
KEY = 11


def _draws(w, name, step):
    d = _jax_draws(jax.random.PRNGKey(KEY), step, N_RAYS * S)
    if name == "patch":
        k = jax.random.fold_in(jax.random.PRNGKey(KEY), step)
        rays = j_get_rays(jnp.asarray(w["batch"]["pose"])[None],
                          w["ds"].intrinsics, RES, RES, N=N_RAYS,
                          patch_size=P, rng=jax.random.split(k, 4)[0])
        d["inds"] = np.asarray(rays["inds"][0])
    return {k: np.array(v, np.int64 if k == "inds" else np.float32)
            for k, v in d.items()}


@pytest.fixture(scope="module")
def ranks(world):
    """The port's world-size-2 steps, every case, one launch."""
    w = world
    spec = {
        "device": "cpu",
        "field": dict(audio_in_dim=w["ds"].audio_dim, ind_num=64),
        "state": {k: v.numpy() for k, v in params_from_jax(
            jax.tree.map(np.asarray, w["params"])).items()},
        "settings": dict(bound=1.0, cascade=1, grid_size=GRID, max_steps=S,
                         dt=2 * 3 ** 0.5 / GRID, num_cand=28),
        "occ": {k: v.numpy() for k, v in w["tocc"]._asdict().items()},
        "batch": w["batch"],
        "common": w["common"],
        "cases": [{"step": step, "kw": kw, "draws": _draws(w, name, step),
                   "lpips": FIXTURE if name == "patch" else None}
                  for name, step, kw in CASES]}
    return launch(head_steps, 2, args=(spec,), device="cpu", threads=1)


@pytest.fixture(scope="module")
def jax_dp(world):
    """JAX's steps on a 2-device data mesh, one compile per path."""
    w = world
    sh = j_data_sharding(j_make_mesh("data", jax.devices()[:2]))
    out = {}
    for name, step, kw in CASES:
        if name not in out:
            extra = ({"lpips_params": jlp.load_weights(FIXTURE)}
                     if name == "patch" else {})
            out[name] = jax.jit(j_make_step(
                w["field"], w["jrs"], w["tx"], data_sharding=sh,
                **w["common"], **kw, **extra))
    return out


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{n}-{s}" for n, s, _ in CASES])
def test_data_parallel_step_matches_jax(world, ranks, jax_dp, case):
    w = world
    name, step, kw = CASES[case]
    state = JState.create(w["params"], w["tx"]).replace(
        step=jnp.asarray(step, jnp.int32))
    jb = {k: jnp.asarray(v) for k, v in w["batch"].items()}
    js, jm = jax_dp[name](state, w["jocc"], jb, jax.random.PRNGKey(KEY))
    jgrads = params_from_jax(jax.tree.map(np.asarray, js.opt_state[0]))
    jparams = params_from_jax(jax.tree.map(np.asarray, js.params))

    r0, r1 = ranks[0][case], ranks[1][case]
    assert r0["digest"] == r1["digest"]
    assert r0["metrics"] == r1["metrics"]
    m = r0["metrics"]
    np.testing.assert_allclose(m["loss"], float(jm["loss"]),
                               rtol=1e-6 if name == "full" else LOSS_RTOL)
    np.testing.assert_allclose(m["mse"], float(jm["mse"]), rtol=LOSS_RTOL)
    if "train_budget" in kw:
        assert m["n_active"] == int(jm["n_active"])
        assert m["n_active_over"] == int(jm["n_active_over"])
    tol = 1e-5 if name == "full" else 5e-5
    for n, ref in jgrads.items():
        _assert_grad_close(r0["grads"][n], ref.numpy(), n)
        np.testing.assert_allclose(
            r0["params"][n], jparams[n].numpy(), rtol=0,
            atol=5e-3 if n.startswith("encoder_") else tol, err_msg=n)


def test_mesh_layout_and_shardings():
    """The mesh's shardings in the JAX package's layout: ray i of a batch
    of n lives at [i // n_local, i % n_local]; shard_batch splits the
    per-ray keys and replicates full frames; a one-process batch is its
    own global batch."""
    from lzzx_nerf_tpu_torch.parallel import replicate, shard_batch
    from lzzx_nerf_tpu_torch.parallel.distributed import (
        is_coordinator, local_batch_to_global)

    mesh = make_mesh("data", ["cpu", "cpu"])
    assert mesh.size == 2 and mesh.rank == 0 and mesh.group is None
    sh = data_sharding(mesh)
    x = torch.arange(12)
    for i in range(12):
        assert sh.slice(x, i // 6)[i % 6] == x[i]
    b = {"inds": x, "image": torch.zeros((4, 4, 3)), "index": 3}
    out = shard_batch(b, mesh)
    assert torch.equal(out["inds"], x[:6]) and out["index"] == 3
    assert out["image"].shape == (4, 4, 3)
    assert torch.equal(replicate(mesh).place(x), x)
    with pytest.raises(ValueError, match="mesh's axis"):
        data_sharding(mesh, "dp")
    one = make_mesh("data", ["cpu"])
    g = local_batch_to_global(one, b, sharded_keys=("inds",))
    assert torch.equal(g["inds"], x) and is_coordinator()


def test_data_parallel_step_needs_rays_that_split():
    """num_rays must divide by the ranks (JAX's ValueError)."""
    field = NeRFField(audio_in_dim=29, ind_num=4)
    from lzzx_nerf_tpu_torch.render import RenderSettings

    sh = data_sharding(make_mesh("data", ["cpu", "cpu"]))
    kw = dict(H=RES, W=RES, intrinsics=(40.0, 40.0, 24.0, 24.0), iters=10,
              data_sharding=sh)
    with pytest.raises(ValueError, match="divide by the data-parallel "
                                         "factor 2"):
        make_train_step(field, RenderSettings(), num_rays=1001, **kw)
    make_train_step(field, RenderSettings(), num_rays=1000, **kw)


# ---- the CLI -------------------------------------------------------------

def _cli_args(data, ws, *more):
    return [data, "--workspace", ws, "--asr_model", "deepspeech",
            "--grid_size", "32", "--num_rays", "1024",
            "--train_budget_frac", "1.0", "--train_compact_warmup", "2",
            "--update_extra_interval", "2", "--eval_interval", "100",
            "--iters", "4", "--device", "cpu", *more]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The 32² oracle (8 frames) trained 4 steps (2 full, 2 compacted,
    the grid refreshed every 2) plainly, with --data_parallel 1 (a group of one in this process) and
    with --data_parallel 2 (two gloo ranks the CLI starts)."""
    root = tmp_path_factory.mktemp("dp_cli")
    data = write_synthetic_dataset(str(root / "oracle"), res=32, frames=8,
                                   val=2)["data"]
    out = {}
    for name, more in (("plain", ()), ("dp1", ("--data_parallel", "1")),
                       ("dp2", ("--data_parallel", "2"))):
        ws = str(root / name)
        cli.main(_cli_args(data, ws, *more))
        out[name] = ws
    return out


def test_cli_data_parallel_1_equals_the_plain_run(cli_runs):
    """A world of one sums nothing: every leaf of the last checkpoint
    (parameters, EMA, moments, occupancy, the generator's state) equals
    the plain run's bit for bit, in the port's format (no module.
    prefixes)."""
    a = read_checkpoint(os.path.join(cli_runs["plain"], "checkpoints"))
    b = read_checkpoint(os.path.join(cli_runs["dp1"], "checkpoints"))
    assert int(b["state"]["step"]) == 4
    fa, fb = _leaves(a), _leaves(b)
    assert fa.keys() == fb.keys()
    assert not any("module." in k for k in fb)
    for k in fa:
        np.testing.assert_array_equal(fb[k], fa[k], err_msg=k)
    assert "[INFO] data-parallel over 1 devices" in open(os.path.join(
        cli_runs["dp1"], "log_ngp.txt")).read()


def test_cli_data_parallel_2_over_gloo(cli_runs):
    """--device cpu --data_parallel 2: the CLI starts two gloo ranks; rank
    0 alone logs, writes opt.txt and the checkpoints, in the port's format
    with the generator's state, and the run trains (finite parameters that
    moved). Its numbers against the single-device step are the step
    parity above: after several Adam steps the runs part wherever a
    near-zero gradient's sign depends on the summation order."""
    ws = cli_runs["dp2"]
    log = open(os.path.join(ws, "log_ngp.txt")).read()
    assert log.count("[INFO] data-parallel over 2 devices") == 1
    assert log.count("[INFO] training done") == 1
    with open(os.path.join(ws, "opt.txt")) as f:
        assert len([ln for ln in f if ln.strip()]) == 1
    a = read_checkpoint(os.path.join(cli_runs["plain"], "checkpoints"))
    b = read_checkpoint(os.path.join(ws, "checkpoints"))
    assert int(b["state"]["step"]) == 4 and b["generator"] is not None
    assert _leaves(a).keys() == _leaves(b).keys()
    # the EMA moves every 1,000 steps: after 4 it holds the initial values
    pb = params_from_jax(b["state"]["params"]["params"])
    init = params_from_jax(b["state"]["ema_params"])
    for k, v in pb.items():
        assert torch.isfinite(v).all(), k
        if k.startswith("sigma_net"):
            assert not torch.equal(v, init[k]), k


def test_cli_data_parallel_exits_without_the_gpus(tmp_path, monkeypatch):
    """--data_parallel 2 where one GPU is visible exits with the JAX CLI's
    message before it reads anything; it does not carry on elsewhere."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="--data_parallel 2 but only 1 "
                                         "devices visible"):
        cli.main([str(tmp_path), "--workspace", str(tmp_path / "ws"),
                  "--data_parallel", "2"])


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix: np.asarray(tree)}
