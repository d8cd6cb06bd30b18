"""The port's CUDA kernels against their plain PyTorch versions on the card.

These need a CUDA device and skip without one (the check runs inside the
fixture). The module imports neither JAX nor the JAX package, so on a GPU
machine without JAX it runs on its own:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from lzzx_nerf_tpu_torch import kernels
from lzzx_nerf_tpu_torch.models import NeRFField
from lzzx_nerf_tpu_torch.ops import fused_field as ff
from lzzx_nerf_tpu_torch.ops import march2 as m2
from lzzx_nerf_tpu_torch.ops import packed_triplane as pt
from lzzx_nerf_tpu_torch.ops.march_select import (march_select_cuda,
                                                  march_select_reference)
from lzzx_nerf_tpu_torch.ops.sh import sh_encode


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    kernels.build()
    return torch.device("cuda:0")


def _random_field(device, seed):
    """A NeRFField with random weights and triplane levels (numpy seed),
    its folded frame weights and its bf16 packed tables on `device`."""
    rng = np.random.default_rng(seed)
    field = NeRFField(audio_in_dim=29, ind_num=8)
    with torch.no_grad():
        for name, p in field.named_parameters():
            scale = 0.5 if name.startswith("encoder_") else 0.2
            p.copy_(torch.from_numpy(
                rng.uniform(-scale, scale, p.shape).astype(np.float32)))
    field.to(device)
    fw = ff.fold_frame_weights(
        ff.extract_field_weights(field),
        torch.from_numpy(rng.normal(0, 0.3, (1, 32)).astype(np.float32)
                         ).to(device),
        torch.from_numpy(rng.normal(0, 0.1, 4).astype(np.float32)).to(device),
        torch.tensor([0.3], device=device))
    return field, fw, field.bake_tables(torch.bfloat16)


def _points(n, seed, device, reach=1.2):
    """n points in [-reach, reach]^3 (outside the box where reach > 1) and
    unit directions, from a numpy seed."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-reach, reach, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(pts).to(device), torch.from_numpy(d).to(device)


@pytest.mark.parametrize("n", [1, 127, 128, 5000, 70001])
def test_field_kernel_matches_plain(cuda, n):
    """Field kernel (lookup + SH + MLP) vs field_reference, with points
    inside and outside the box: sigma to 1e-4 relative, colors to 1e-5
    absolute (float32 sums in another order; 3xTF32 products)."""
    field, fw, tables = _random_field(cuda, n)
    pts, d = _points(n, n + 1, cuda)
    before = kernels.launches["fused_field"]
    out = ff.fused_field_cuda(pts, d, tables["xy"], tables["yz"],
                              tables["xz"], field.bound,
                              ff.pack_frame_weights(fw))
    ref = ff.field_reference(fw, pts, d, tables, field.dense_spec,
                             field.bound)
    torch.cuda.synchronize()
    assert kernels.launches["fused_field"] == before + 1
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out[:, 0], ref[:, 0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(out[:, 1:], ref[:, 1:], rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 127, 5000, 70001])
def test_field_enc_entry_matches_plain(cuda, n):
    """The enc_x entry (the Pallas kernel's function: enc_x and the
    directions) vs fused_field_reference of enc_x and the SH basis, at N
    that are and are not multiples of a warp's 16 rows, and N = 0 (no
    launch): sigma to 1e-4 relative, colors to 1e-5 absolute."""
    _, fw, _ = _random_field(cuda, n + 3)
    rng = np.random.default_rng(n + 4)
    enc_x = torch.from_numpy(rng.uniform(-0.5, 0.5, (n, 36)).astype(
        np.float32)).to(cuda)
    _, d = _points(n, n + 2, cuda)
    before = kernels.launches["fused_field_enc"]
    out = ff.fused_field_enc_cuda(enc_x, d, ff.pack_frame_weights(fw))
    ref = ff.fused_field_reference(fw, enc_x, sh_encode(d, 4))
    torch.cuda.synchronize()
    assert out.shape == (n, 4)
    assert kernels.launches["fused_field_enc"] == before + (1 if n else 0)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out[:, 0], ref[:, 0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(out[:, 1:], ref[:, 1:], rtol=0, atol=1e-5)


def test_field_enc_entry_rejects_bad_inputs(cuda):
    _, fw, _ = _random_field(cuda, 5)
    _, d = _points(8, 6, cuda)
    w = ff.pack_frame_weights(fw)
    enc = torch.zeros(8, 36, device=cuda)
    shifted = torch.zeros(8 * 36 + 1, device=cuda)[1:].view(8, 36)
    for args in ((enc.double(), d, w), (enc[:, :35].contiguous(), d, w),
                 (enc, d[:7], w), (enc, d, w[:-1]), (shifted, d, w),
                 (enc.cpu(), d, w)):
        with pytest.raises(ValueError):
            ff.fused_field_enc_cuda(*args)


def test_hash_head_serving_field_on_card(cuda):
    """A hash head's serving field (grid_encode on the card, then the enc_x
    entry) against the plain version on the card and on the CPU."""
    from lzzx_nerf_tpu_torch.models.nerf import make_fused_apply

    rng = np.random.default_rng(9)
    field = NeRFField(audio_in_dim=29, ind_num=8, encoder="hash")
    with torch.no_grad():
        for name, p in field.named_parameters():
            scale = 0.5 if name.startswith("encoder_") else 0.2
            p.copy_(torch.from_numpy(
                rng.uniform(-scale, scale, p.shape).astype(np.float32)))
    enc_a = torch.from_numpy(rng.normal(0, 0.3, (1, 32)).astype(np.float32))
    pts, d = _points(20000, 10, "cpu", reach=1.05)
    outs = {}
    for dev, kernel in ((cuda, True), (cuda, False), ("cpu", False)):
        f = field.to(dev)
        before = kernels.launches["fused_field_enc"]
        outs[(str(dev), kernel)] = [t.cpu() for t in make_fused_apply(
            f, {}, enc_a.to(dev), f.individual_codes[0].detach(),
            torch.tensor([0.3], device=dev), use_kernel=kernel)(
            pts.to(dev), d.to(dev))]
        assert kernels.launches["fused_field_enc"] == before + int(kernel)
    k = outs[(str(cuda), True)]
    for ref in (outs[(str(cuda), False)], outs[("cpu", False)]):
        torch.testing.assert_close(k[0], ref[0], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(k[1], ref[1], rtol=0, atol=1e-5)


def test_grid_encode_on_card_matches_cpu(cuda):
    """grid_encode of the tiled torso's spec on the card vs the CPU: the
    forward bit-equal, the table gradient (atomic index_add on the card)
    within 1e-6 of its largest entry."""
    from lzzx_nerf_tpu_torch.models.nerf import torso_tiled_spec
    from lzzx_nerf_tpu_torch.ops.grid import grid_encode

    spec = torso_tiled_spec()
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.uniform(-1.05, 1.05, (40000, 2)).astype(
        np.float32))
    table = torch.from_numpy(rng.standard_normal(
        (spec.total_params, 2)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((40000, 32)).astype(np.float32))
    got = {}
    for dev in (cuda, torch.device("cpu")):
        t = table.to(dev).requires_grad_()
        y = grid_encode(x.to(dev), t, spec)
        (y * w.to(dev)).sum().backward()
        got[dev.type] = (y.detach().cpu(), t.grad.cpu())
    assert torch.equal(got["cuda"][0], got["cpu"][0])
    g = got["cpu"][1]
    torch.testing.assert_close(got["cuda"][1], g, rtol=0,
                               atol=1e-6 * float(g.abs().max()))


def test_field_kernel_outside_box(cuda):
    """Points outside [-bound, bound] on every plane give zero features:
    the kernel's output there equals the field at zero features."""
    field, fw, tables = _random_field(cuda, 11)
    pts, d = _points(4096, 12, cuda)
    pts = torch.where(pts >= 0, pts + 1.5, pts - 1.5)
    out = ff.fused_field_cuda(pts, d, tables["xy"], tables["yz"],
                              tables["xz"], field.bound,
                              ff.pack_frame_weights(fw))
    zero = ff.fused_field_reference(fw, torch.zeros(4096, 36, device=cuda),
                                    sh_encode(d, 4))
    torch.cuda.synchronize()
    torch.testing.assert_close(out[:, 0], zero[:, 0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(out[:, 1:], zero[:, 1:], rtol=0, atol=1e-5)


def test_field_kernel_rejects_bad_inputs(cuda):
    field, fw, tables = _random_field(cuda, 5)
    pts, d = _points(8, 6, cuda)
    w = ff.pack_frame_weights(fw)
    xy, yz, xz = tables["xy"], tables["yz"], tables["xz"]
    b = field.bound
    bad = [
        (pts.double(), d, xy, yz, xz, b, w),                      # dtype
        (pts, d, xy.float(), yz, xz, b, w),                       # table dtype
        (pts[:, :2].contiguous(), d, xy, yz, xz, b, w),           # shape
        (pts, d[:7], xy, yz, xz, b, w),                           # rows
        (pts, d, xy[:-1], yz, xz, b, w),                          # table shape
        (pts, d, xy, yz, xz, b, w[:-1]),                          # weights
        (pts.t().contiguous().t(), d, xy, yz, xz, b, w),          # strides
        (pts.cpu(), d, xy, yz, xz, b, w),                         # device
        (pts, d, xy, yz, xz, b,
         torch.empty(ff.W_TOTAL + 1, device=cuda)[1:]),          # alignment
    ]
    for args in bad:
        with pytest.raises(ValueError):
            ff.fused_field_cuda(*args)
    # 2^31 samples: over the int32 sample count the kernel takes
    big = torch.empty((2 ** 31, 3), device=cuda)
    with pytest.raises(ValueError, match="int32"):
        ff.fused_field_cuda(big, big, xy, yz, xz, b, w)


def test_field_kernel_past_int32_offsets(cuda):
    """At n = 750,000,000 samples, 3 n and 4 n (the float offsets of pts,
    dirs and out) pass 2^31: the kernel's last rows, where they do, still
    read and write their own samples."""
    field, fw, tables = _random_field(cuda, 13)
    n, m = 750_000_000, 4096
    pts = torch.empty((n, 3), device=cuda)
    d = torch.empty((n, 3), device=cuda)
    pts[:] = torch.tensor([0.1, -0.2, 0.3], device=cuda)
    d[:] = torch.tensor([0.0, 0.6, 0.8], device=cuda)
    pts[-m:], d[-m:] = _points(m, 14, cuda)
    out = ff.fused_field_cuda(pts, d, tables["xy"], tables["yz"],
                              tables["xz"], field.bound,
                              ff.pack_frame_weights(fw))
    ref = ff.field_reference(fw, torch.cat([pts[:m], pts[-m:]]),
                             torch.cat([d[:m], d[-m:]]), tables,
                             field.dense_spec, field.bound)
    got = torch.cat([out[:m], out[-m:]])
    torch.cuda.synchronize()
    torch.testing.assert_close(got[:, 0], ref[:, 0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got[:, 1:], ref[:, 1:], rtol=0, atol=1e-5)


def test_fused_apply_runs_no_eager_lookup(cuda, monkeypatch):
    """make_fused_apply on a CUDA device hands points and directions to the
    field kernel: the triplane lookup and the SH basis run inside it, never
    as eager ops (each eager path raises here), in one launch per call."""
    from lzzx_nerf_tpu_torch.models import make_fused_apply

    field, fw, tables = _random_field(cuda, 9)
    pts, d = _points(1000, 10, cuda)
    enc_a = torch.zeros(1, 32, device=cuda)
    want = ff.field_reference(
        ff.fold_frame_weights(ff.extract_field_weights(field), enc_a, None,
                              None), pts, d, tables, field.dense_spec,
        field.bound)

    def eager(*a, **k):
        raise AssertionError("eager lookup or SH basis on the kernel path")

    for name in ("encode_triplanes", "sh_encode", "field_reference",
                 "fused_field_reference"):
        monkeypatch.setattr(ff, name, eager)
    for name in ("encode_triplanes", "dense_triplane_encode",
                 "packed_lookup"):
        monkeypatch.setattr(pt, name, eager)
    monkeypatch.setattr(NeRFField, "encode_x", eager)
    apply = make_fused_apply(field, tables, enc_a, None, None)
    before = kernels.launches["fused_field"]
    sigma, color = apply(pts, d)
    torch.cuda.synchronize()
    assert kernels.launches["fused_field"] == before + 1
    torch.testing.assert_close(sigma, want[:, 0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(color, want[:, 1:], rtol=0, atol=1e-5)


def _blob_occ(grid, seed):
    rng = np.random.default_rng(seed)
    occ = np.zeros((grid, grid, grid), bool)
    x, y, z = np.ogrid[:grid, :grid, :grid]
    for _ in range(14):
        c = rng.integers(4, grid - 4, 3)
        r = rng.integers(2, max(3, grid // 6))
        occ |= ((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2) < r * r
    return torch.from_numpy(occ)[None]


@pytest.mark.parametrize("grid,K2,S,scene,bound", [
    (32, 40, 16, "blobs", 1.0), (64, 45, 12, "blobs", 1.0),
    (128, 82, 16, "blobs", 1.0), (128, 61, 32, "blobs", 1.0),
    (128, 82, 1, "blobs", 1.0), (64, 90, 32, "blobs", 1.0),
    (64, 82, 16, "blobs", 0.75), (64, 82, 16, "full", 1.0),
    (64, 82, 16, "empty", 1.0)])
def test_march_select_kernel_equal_to_plain(cuda, grid, K2, S, scene, bound):
    """Select kernel vs march_select_reference on camera blocks over a
    blob scene, a full grid (every ray fills S early) and an empty grid
    (no ray has a sample), with a power-of-two bound and without: equal
    sample indices."""
    occ = _blob_occ(grid, grid + K2)
    if scene != "blobs":
        occ = torch.full_like(occ, scene == "full")
    occ = occ.to(cuda)
    table = m2.column_bitmasks_neighborhood5_words(occ)
    H = W = 128
    dt = 2 * 3 ** 0.5 / grid
    a = 0.2
    pose = torch.tensor([[np.cos(a), 0, np.sin(a), 0.03], [0, 1, 0, 0.0],
                         [-np.sin(a), 0, np.cos(a), -2.5], [0, 0, 0, 1]],
                        dtype=torch.float32, device=cuda)
    from lzzx_nerf_tpu_torch.ops.ray import near_far_from_aabb
    from lzzx_nerf_tpu_torch.utils import get_rays

    rays = get_rays(pose[None], (W / 0.35, W / 0.35, W / 2, H / 2), H, W)
    db, dc = m2.block_view(rays["rays_d"][0], H, W)
    rd = db.reshape(-1, 3).contiguous()
    ro = rays["rays_o"][0, :1].expand(rd.shape).contiguous()
    aabb = torch.tensor([-1, -0.5, -1, 1, 0.5, 1], device=cuda)
    nr, fr = near_far_from_aabb(ro, rd, aabb, 0.05)
    ts = nr.contiguous()
    te = torch.minimum(fr, nr + K2 * dt).contiguous()
    sv = torch.rand(rd.shape[0], device=cuda) < 0.9
    G = (K2 + 1) // 2
    Bb = rd.shape[0] // 4
    oc = ro.reshape(Bb, 4, 3)[:, 0]
    gk = torch.arange(G, device=cuda, dtype=torch.float32) * 2 + 1.0
    t_g = nr.reshape(Bb, 4)[:, 0, None] + gk * dt
    pg = torch.clamp(oc[:, None] + t_g[..., None] * dc[:, None], -1, 1)
    q = torch.clamp((pg + 1) * 0.5 * grid, 0, grid - 1).to(torch.int32)
    gx, gy = q[..., 0].contiguous(), q[..., 1].contiguous()
    w0 = torch.clamp(torch.clamp(q[..., 2] - 3, min=0) >> 5, 0,
                     grid // 32 - 1).contiguous()
    args = (table, gx, gy, w0, ro, rd, ts, te, sv, bound, dt, grid, K2, S)
    got = march_select_cuda(*args)
    want = march_select_reference(*args)
    torch.cuda.synchronize()
    if scene == "empty":
        assert (want < 0).all()
    elif scene == "full":
        # every ray with a slot and a long enough span fills all S slots
        assert (want[:, -1] >= 0).sum() > 1000
    else:
        assert (want >= 0).sum() > 1000
    assert torch.equal(got, want)


def test_wrappers_launch_kernels_on_cuda(cuda):
    """On CUDA tensors the wrappers launch their kernels (one count each)
    and agree with the plain versions; they never run the plain version
    there."""
    field, fw, tables = _random_field(cuda, 7)
    pts, d = _points(300, 8, cuda)
    before = dict(kernels.launches)
    sig, col = ff.fused_field_eval(fw, pts, d, tables, field.dense_spec,
                                   field.bound)
    ref = ff.field_reference(fw, pts, d, tables, field.dense_spec,
                             field.bound)
    sig_p, col_p = ref[:, 0], ref[:, 1:]
    occ = _blob_occ(32, 3).to(cuda)
    table = m2.column_bitmasks_neighborhood5_words(occ)
    z = torch.zeros((2, 3), dtype=torch.int32, device=cuda)
    ro = torch.zeros((8, 3), device=cuda)
    rd = torch.tensor([[0.0, 0.0, 1.0]], device=cuda).expand(8, 3)
    ts = torch.full((8,), 0.0, device=cuda)
    te = torch.full((8,), 1.0, device=cuda)
    sv = torch.ones(8, dtype=torch.bool, device=cuda)
    args = (table, z, z, z, ro, rd, ts, te, sv, 1.0, 0.1, 32, 6, 4)
    sel = m2.march_select(*args)
    sel_p = march_select_reference(*args)
    torch.cuda.synchronize()
    assert kernels.launches["fused_field"] == before["fused_field"] + 1
    assert kernels.launches["march_select"] == before["march_select"] + 1
    torch.testing.assert_close(sig, sig_p, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(col, col_p, rtol=0, atol=1e-5)
    assert torch.equal(sel, sel_p)


def test_session_graph_equals_eager(cuda):
    """The session's chunk program captured as a CUDA graph renders the
    eager program's bytes and counters (128², pose 0, a padded tail
    chunk); its replays count the launches the capture recorded."""
    import os

    from lzzx_nerf_tpu_torch.serving import ServingSession
    from lzzx_nerf_tpu_torch.serving.state_io import load_trained_state

    state = os.path.join(os.path.dirname(__file__), "..", "trained",
                         "production_state.pkl")
    poses = load_trained_state(state)["meta"]["poses"][:1]
    # the stage-2 budget pinned at the ray budget: no stage-2 escape
    # rebuilds the plan between the eager and the captured run
    s = ServingSession(state, device=cuda, res=128, poses=poses, chunk=2,
                       log=lambda m: None, stage2_budget=1 << 30)
    rng = np.random.default_rng(4)
    auds = rng.standard_normal((5, 8, 16, 29)).astype(np.float32)
    eyes = [0.2 + 0.03 * f for f in range(5)]
    eager = s.render(auds, eyes, graph=False)
    s.reset_audio()
    kernels.reset_launches()
    cap = s.render(auds, eyes, graph=True)
    assert s.captures == 1
    for a, b in zip(eager["frames"], cap["frames"]):
        np.testing.assert_array_equal(a, b)
    for k in ("n_active", "n_winmax", "n_stage2", "n_real", "n_long"):
        assert eager[k] == cap[k]
    # the warm-up frame of the capture, then 3 chunks of 2 frames:
    # 2 field and 2 select launches a frame
    assert kernels.launches == {"fused_field": 2 * 7, "fused_field_enc": 0,
                                "march_select": 2 * 7}
