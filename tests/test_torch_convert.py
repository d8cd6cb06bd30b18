"""The port's reference-checkpoint interchange (utils/convert.py,
tools/import_reference_ckpt.py, tools/export_reference_ckpt.py) against
the JAX package's (utils/convert.py, scripts/import_reference_ckpt.py), on
the CPU.

The reference layout is tests/test_convert.py's (network.py:97-167:
AudioNet, AudioAttNet, the five MLPs, three hash tables of
triplane_spec(1), the individual codes; the torso's two MLPs, tiled table
and anchors), rebuilt here from a numpy seed at the deepspeech width
(audio_in_dim 29), 64 identities.

Tolerances: none. The converted state dict equals params_from_jax of
JAX's conversion bit for bit; export after import gives back every tensor
bit for bit, head and torso; a production state's tiled torso leaves
nest back bit for bit; the import tool's occupancy is the
thresholded reference grid cell for cell; the exported .pth converts
through JAX's convert.py to JAX's tree of the original, bit for bit, and
its density grid, bitfield, step and means are the original's.
"""

import os
import pickle

import jax
import numpy as np
import pytest
import torch

from lzzx_nerf_tpu.models.nerf import torso_tiled_spec, triplane_spec
from lzzx_nerf_tpu.utils import convert as jconv
from lzzx_nerf_tpu_torch import cli
from lzzx_nerf_tpu_torch.models import NeRFField, TorsoField
from lzzx_nerf_tpu_torch.ops.morton import morton_perm
from lzzx_nerf_tpu_torch.serving.state_io import (TORSO_TILED_LEAF_PATHS,
                                                  flatten_paths,
                                                  load_trained_state,
                                                  params_from_jax,
                                                  params_to_jax,
                                                  read_checkpoint,
                                                  torso_encoder)
from lzzx_nerf_tpu_torch.tools import export_reference_ckpt as texport
from lzzx_nerf_tpu_torch.tools import import_reference_ckpt as timport
from lzzx_nerf_tpu_torch.utils import convert as tconv
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

AUDIO_IN = 29
IND_NUM, IND_DIM = 64, 4
GRID = 32


def reference_state(seed=0, table_scale=1e-2):
    """Random weights in the reference's parameter layout, numpy float32."""
    rng = np.random.default_rng(seed)
    sd = {}

    def r(*shape, s=0.1):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    convs = [(AUDIO_IN, 32), (32, 32), (32, 64), (64, 64)]
    for (cin, cout), lyr in zip(convs, (0, 2, 4, 6)):
        sd[f"audio_net.encoder_conv.{lyr}.weight"] = r(cout, cin, 3)
        sd[f"audio_net.encoder_conv.{lyr}.bias"] = r(cout)
    sd["audio_net.encoder_fc1.0.weight"] = r(64, 64)
    sd["audio_net.encoder_fc1.0.bias"] = r(64)
    sd["audio_net.encoder_fc1.2.weight"] = r(32, 64)
    sd["audio_net.encoder_fc1.2.bias"] = r(32)
    att = [(32, 16), (16, 8), (8, 4), (4, 2), (2, 1)]
    for (cin, cout), lyr in zip(att, (0, 2, 4, 6, 8)):
        sd[f"audio_att_net.attentionConvNet.{lyr}.weight"] = r(cout, cin, 3)
        sd[f"audio_att_net.attentionConvNet.{lyr}.bias"] = r(cout)
    sd["audio_att_net.attentionNet.0.weight"] = r(8, 8)
    sd["audio_att_net.attentionNet.0.bias"] = r(8)
    for prefix, dims in (("sigma_net", [(69, 64), (64, 64), (64, 65)]),
                         ("color_net", [(84, 64), (64, 3)]),
                         ("unc_net", [(36, 32), (32, 1)]),
                         ("aud_ch_att_net", [(36, 64), (64, 32)]),
                         ("eye_att_net", [(36, 16), (16, 1)])):
        for lyr, (i, o) in enumerate(dims):
            sd[f"{prefix}.net.{lyr}.weight"] = r(o, i)
    rows = triplane_spec(1.0).total_params
    for p in ("xy", "yz", "xz"):
        sd[f"encoder_{p}.embeddings"] = r(rows, 1, s=table_scale)
    sd["individual_codes"] = r(IND_NUM, IND_DIM)
    return sd


def reference_torso(seed=1, table_scale=0.1):
    """A torso state dict in the reference's layout (tiled table)."""
    rng = np.random.default_rng(seed)
    sd = {"anchor_points": rng.uniform(-0.1, 0.1, (3, 4)).astype(np.float32),
          "torso_encoder.embeddings": (rng.standard_normal(
              (torso_tiled_spec().total_params, 2)) * table_scale
          ).astype(np.float32),
          "individual_codes_torso": (rng.standard_normal((IND_NUM, 8))
                                     * 0.1).astype(np.float32)}
    sd["anchor_points"][:, 2:] = (0.1, 1.0)
    for name, dims in (("torso_deform_net", [(84, 32), (32, 32), (32, 2)]),
                       ("torso_net", [(116, 32), (32, 32), (32, 4)])):
        for lyr, (i, o) in enumerate(dims):
            sd[f"{name}.net.{lyr}.weight"] = (
                rng.standard_normal((o, i)) * 0.1).astype(np.float32)
    return sd


def to_morton(natural):
    flat = np.zeros((natural.shape[0], natural[0].size), natural.dtype)
    flat[:, morton_perm(natural.shape[-1])] = natural.reshape(
        natural.shape[0], -1)
    return flat


def write_reference_pth(path, sd, natural=None, torso=None, **extra):
    """A .pth the reference writes: {"model": tensors, ...extra}."""
    model = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    if natural is not None:
        model["density_grid"] = torch.from_numpy(to_morton(natural))
    if torso is not None:
        model.update({k: torch.from_numpy(np.array(v))
                      for k, v in torso.items()})
    torch.save({"model": model, **extra}, path)


def _bits_equal(a, b, what):
    a = torch.as_tensor(a).contiguous()
    b = torch.as_tensor(b).contiguous()
    assert a.shape == b.shape and a.dtype == b.dtype, what
    assert torch.equal(a.view(torch.int32), b.view(torch.int32)), what


def _jax_tree(sd):
    return params_from_jax(jax.tree.map(np.asarray, sd))


def test_convert_equals_jax_bit_for_bit():
    sd = reference_state(seed=3)
    got = tconv.convert_reference_state_dict(sd)
    want = _jax_tree(jconv.convert_reference_state_dict(sd))
    assert sorted(got) == sorted(want)
    for k in want:
        _bits_equal(got[k], want[k], k)
    f = NeRFField(audio_in_dim=AUDIO_IN, ind_num=IND_NUM, encoder="hash")
    own = f.state_dict()
    assert sorted(own) == sorted(got)
    f.load_state_dict(got)
    tsd = reference_torso(seed=4)
    got_t = tconv.convert_reference_torso(tsd)
    want_t = _jax_tree(jconv.convert_reference_torso(tsd))
    assert sorted(got_t) == sorted(want_t)
    for k in want_t:
        _bits_equal(got_t[k], want_t[k], k)
    TorsoField(ind_num=IND_NUM, encoder="tiled").load_state_dict(got_t)
    with pytest.raises(KeyError, match="sigma_net"):
        tconv.convert_reference_state_dict(
            {k: v for k, v in sd.items() if not k.startswith("sigma_net")})


def test_export_import_is_the_identity():
    sd = reference_state(seed=5)
    back = tconv.export_reference_state_dict(
        tconv.convert_reference_state_dict(sd))
    assert sorted(back) == sorted(sd)
    for k in sd:
        _bits_equal(back[k], sd[k], k)
    # the port's state dict -> reference -> port (a trained field's,
    # camera refinement left out)
    f = NeRFField(audio_in_dim=AUDIO_IN, ind_num=IND_NUM, encoder="hash",
                  camera_frames=IND_NUM)
    f.init_params(torch.Generator().manual_seed(0))
    own = f.state_dict()
    again = tconv.convert_reference_state_dict(
        tconv.export_reference_state_dict(own))
    assert sorted(again) == sorted(k for k in own if "camera" not in k)
    for k in again:
        _bits_equal(again[k], own[k], k)
    tsd = reference_torso(seed=6)
    tback = tconv.export_reference_torso(tconv.convert_reference_torso(tsd))
    assert sorted(tback) == sorted(tsd)
    for k in tsd:
        _bits_equal(tback[k], tsd[k], k)


def test_production_state_holds_a_tiled_torso(tmp_path):
    """A production state's tiled torso: its 9 leaves in sorted key-path
    order (TORSO_TILED_LEAF_PATHS) nest back into the tree, bit for
    bit."""
    tsd = tconv.convert_reference_torso(reference_torso(seed=9))
    flat = flatten_paths(params_to_jax(tsd))
    assert tuple(sorted(flat)) == TORSO_TILED_LEAF_PATHS
    path = tmp_path / "production_state.pkl"
    with open(path, "wb") as f:
        pickle.dump({"head_ema": {}, "occ": {}, "meta": {},
                     "torso_leaves": [flat[k] for k in
                                      TORSO_TILED_LEAF_PATHS]}, f)
    torso = load_trained_state(str(path))["torso"]
    assert torso_encoder(torso) == "tiled"
    back = params_from_jax(torso)
    assert sorted(back) == sorted(tsd)
    for k in tsd:
        _bits_equal(back[k], tsd[k], k)


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    """A reference .pth (head, torso, Morton density grid, torso grid)
    imported by the port's tool into a workspace over the toy dataset."""
    from conftest import make_toy_dataset

    root = tmp_path_factory.mktemp("ref")
    data = make_toy_dataset(root / "data")
    sd = reference_state(seed=2)
    rng = np.random.default_rng(2)
    natural = rng.uniform(0, 20, (1, GRID, GRID, GRID)).astype(np.float32)
    tsd = reference_torso(seed=7)
    tsd["density_grid_torso"] = rng.uniform(0, 1, GRID * GRID).astype(
        np.float32)
    pth = root / "ngp_ep0001.pth"
    write_reference_pth(pth, sd, natural, mean_density=2.0, global_step=123)
    tpth = root / "ngp_torso.pth"
    write_reference_pth(tpth, tsd, mean_density_torso=0.25, global_step=9)
    ws = str(root / "ws")
    logs = []
    out = timport.main(["--ckpt", str(pth), "--data", data, "--workspace",
                        ws, "--asr_model", "deepspeech", "--grid_size",
                        str(GRID), "--torso-ckpt", str(tpth), "--device",
                        "cpu"], log=logs.append)
    return dict(root=root, data=data, sd=sd, tsd=tsd, natural=natural,
                ws=ws, out=out, logs=logs)


def test_import_tool_writes_a_workspace_the_cli_tests(imported):
    w = imported
    ws, data = w["ws"], w["data"]
    assert w["out"]["missing"] == []
    ck = read_checkpoint(os.path.join(ws, "checkpoints"))
    assert int(ck["state"]["step"]) == 123
    # the EMA weights are the imported ones
    conv = tconv.convert_reference_state_dict(w["sd"])
    ema = params_from_jax(ck["state"]["ema_params"])
    for k, v in conv.items():
        _bits_equal(ema[k], v, k)
    # occupancy = the de-Mortonised grid above min(10, mean_density 2.0)
    np.testing.assert_array_equal(ck["occ"]["density_grid"], w["natural"])
    np.testing.assert_array_equal(ck["occ"]["occ"], w["natural"] > 2.0)
    assert w["out"]["occupied"] == int((w["natural"] > 2.0).sum())
    tck = read_checkpoint(os.path.join(ws + "_torso", "checkpoints"))
    np.testing.assert_array_equal(
        tck["occ"]["density_grid_torso"].reshape(-1),
        w["tsd"]["density_grid_torso"])
    assert float(tck["occ"]["mean_density_torso"]) == 0.25
    with open(os.path.join(ws, "opt.txt")) as f:
        last = f.read().strip().splitlines()[-1]
    assert '"encoder": "hash"' in last and f'"grid_size": {GRID}' in last

    cli.main([data, "--workspace", ws, "--encoder", "hash", "--asr_model",
              "deepspeech", "--test", "1", "--test_train", "1",
              "--grid_size", str(GRID), "--max_steps", "8", "--ind_num",
              str(IND_NUM), "--infer_samples", "8",
              "--infer_window_candidates", "24", "--torso", "1",
              "--device", "cpu"])
    pngs = [f for f in os.listdir(os.path.join(ws, "results"))
            if f.endswith(".png")]
    assert len(pngs) == 6
    log = open(os.path.join(ws, "log_ngp.txt")).read()
    assert "ckpt resumed=True" in log and "resumed=True" in log


def test_import_without_a_grid_marks_the_unseen_cells(imported, tmp_path):
    w = imported
    pth = tmp_path / "best.pth"
    write_reference_pth(pth, w["sd"])
    logs = []
    out = timport.main(["--ckpt", str(pth), "--data", w["data"],
                        "--workspace", str(tmp_path / "ws"), "--asr_model",
                        "deepspeech", "--grid_size", str(GRID), "--device",
                        "cpu"], log=logs.append)
    assert out["occupied"] is None and out["torso_workspace"] is None
    assert any("no density grid" in m for m in logs)
    ck = read_checkpoint(str(tmp_path / "ws" / "checkpoints"))
    assert (ck["occ"]["density_grid"] == -1).any()
    with pytest.raises(SystemExit, match="grid_size"):
        timport.main(["--ckpt", str(w["root"] / "ngp_ep0001.pth"), "--data",
                      w["data"], "--workspace", str(tmp_path / "ws2"),
                      "--asr_model", "deepspeech", "--grid_size", "24",
                      "--device", "cpu"], log=logs.append)


def test_export_tool_pth_converts_through_jax(imported, tmp_path):
    """The port's export of the imported workspace, read by JAX's
    convert.py, is JAX's conversion of the original; the grid, bitfield,
    step and means round-trip, and the torso too."""
    w = imported
    out = str(tmp_path / "back.pth")
    texport.main(["--workspace", w["ws"], "--data", w["data"], "--out", out,
                  "--asr_model", "deepspeech", "--grid_size", str(GRID),
                  "--torso-workspace", w["ws"] + "_torso", "--device",
                  "cpu"], log=lambda m: None)
    back = torch.load(out, map_location="cpu", weights_only=False)
    bsd = back["model"]
    assert back["global_step"] == 123
    assert back["mean_density"] == 2.0
    assert back["mean_density_torso"] == 0.25

    def jtree(d):
        return _jax_tree(d)

    got = jtree(jconv.convert_reference_state_dict(bsd))
    want = jtree(jconv.convert_reference_state_dict(w["sd"]))
    assert sorted(got) == sorted(want)
    for k in want:
        _bits_equal(got[k], want[k], k)
    got_t = jtree(jconv.convert_reference_torso(bsd))
    want_t = jtree(jconv.convert_reference_torso(w["tsd"]))
    for k in want_t:
        _bits_equal(got_t[k], want_t[k], k)
    np.testing.assert_array_equal(bsd["density_grid"].numpy(),
                                  to_morton(w["natural"]))
    np.testing.assert_array_equal(bsd["density_grid_torso"].numpy(),
                                  w["tsd"]["density_grid_torso"])
    bits = np.unpackbits(bsd["density_bitfield"].numpy(), bitorder="little")
    np.testing.assert_array_equal(
        bits.astype(bool), to_morton(w["natural"] > 2.0).reshape(-1))
    # a dense workspace has no reference layout
    dense = tmp_path / "dense"
    os.makedirs(dense)
    with open(dense / "opt.txt", "w") as f:
        f.write('{"encoder": "dense"}\n')
    with pytest.raises(SystemExit, match="encoder='dense'"):
        texport.main(["--workspace", str(dense), "--data", w["data"],
                      "--out", out, "--device", "cpu"], log=lambda m: None)
