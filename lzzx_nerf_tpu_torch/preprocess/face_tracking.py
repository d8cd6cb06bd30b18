"""3DMM head-pose tracking (task 8), the port of
lzzx_nerf_tpu/preprocess/face_tracking.py to PyTorch.

Reference: data_utils/face_tracking/ (facemodel.py Face_3DMM, util.py
geometry helpers, ajian_util.py fit loops, face_tracker.py main). The
pipeline: focal search (600..1400) -> coarse landmark fit over all frames
-> photometric light/texture fit -> fine batched fit with laplacian
temporal smoothing, resumable from track_iter_params.npz.

As in the JAX package, the photometric stage point-splats the vertices
with a differentiable bilinear scatter-add under 9-band spherical-harmonics
lighting over per-vertex BFM albedo, with a soft z-buffer; it runs when the
BFM assets include the texture basis and topology.

The port's differences from the JAX module are of mechanism, not of
arithmetic:
- parameters are tensors on an explicit device (the model's); every fit
  step runs eagerly (JAX jits each step), so the host sets the pace of
  the ~45,000 small steps of track_video;
- the optimiser is `OptaxAdam`, which follows optax.adam's update
  operation for operation (torch.optim.Adam orders them differently, and
  over the focal search's thousands of steps the two drift apart);
- the z-buffer is a scatter_reduce "amin" (order-free); the splat's
  additions are scatter_adds, float atomics on a GPU, so a run on the card
  matches the CPU within a tolerance and is not bitwise repeatable;
- float32 matmuls stay float32 on the GPU: importing this module turns
  TF32 off, as models/audio.py does.

Convention notes (kept bit-compatible with the reference):
- euler2rot reproduces the tracker's own convention (util.py:18-50:
  standard R_x/R_y, transposed R_z) — NOT the pytorch3d convention in
  utils/pose.py.
- projection: x' = -f*X/Z + cx, y' = f*Y/Z + cy (util.py:73-83).
- contour landmarks 0..7 / 9..16 snap to the extreme-x candidate vertex of
  per-landmark contour sets (facemodel.py get_3dlandmarks); ties go to
  the first index, as in JAX.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.clip import clip

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


# ---------- geometry (util.py ports) ----------

def euler2rot(euler: torch.Tensor) -> torch.Tensor:
    """[B, 3] -> [B, 3, 3], tracker convention (util.py:18-50): the
    standard R_x(t) @ R_y(p) and a transposed R_z(s)."""
    t, p, s = euler[:, 0], euler[:, 1], euler[:, 2]
    z = torch.zeros_like(t)
    o = torch.ones_like(t)
    rot_x = torch.stack([o, z, z, z, torch.cos(t), -torch.sin(t),
                         z, torch.sin(t), torch.cos(t)], -1).reshape(-1, 3, 3)
    rot_y = torch.stack([torch.cos(p), z, torch.sin(p), z, o, z,
                         -torch.sin(p), z, torch.cos(p)], -1).reshape(-1, 3, 3)
    rot_z = torch.stack([torch.cos(s), torch.sin(s), z, -torch.sin(s),
                         torch.cos(s), z, z, z, o], -1).reshape(-1, 3, 3)
    return rot_x @ rot_y @ rot_z


def forward_transform(geometry, euler, trans, focal, cxy):
    """[B, N, 3] model pts -> [B, N, 3] (x', y', Z) projections
    (util.py:73-97)."""
    rot = euler2rot(euler)
    g = torch.einsum("bij,bnj->bni", rot, geometry) + trans[:, None, :]
    X, Y, Z = g[..., 0], g[..., 1], g[..., 2]
    px = -focal * X / Z + cxy[0]
    py = focal * Y / Z + cxy[1]
    return torch.stack([px, py, Z], -1)


def lap_loss_1d(x: torch.Tensor) -> torch.Tensor:
    """Temporal laplacian (-0.5, 1, -0.5) over the frame axis
    (util.py:52-66); x: [F, D]."""
    if x.shape[0] < 3:
        return x.new_zeros(())
    lap = -0.5 * x[:-2] + x[1:-1] - 0.5 * x[2:]
    return torch.mean(lap ** 2)


# ---------- model ----------

def _load_tris(info: dict, modelpath: str) -> Optional[np.ndarray]:
    """Triangle topology: 3DMM_info.npy['tris'] (scripts/convert_bfm.py),
    else the reference's topology_info.npy."""
    if "tris" in info:
        return np.asarray(info["tris"], np.int64)
    topo_p = os.path.join(modelpath, "topology_info.npy")
    if os.path.exists(topo_p):
        topo = np.load(topo_p, allow_pickle=True).item()
        if "tris" in topo:
            return np.asarray(topo["tris"], np.int64)
    return None


@dataclass
class Face3DMM:
    """BFM bases (facemodel.py:8-50) as float32 tensors on one device.
    Loads 3DMM_info.npy + keys_info.npy from `modelpath`; raises with
    instructions when absent. Texture basis + topology are optional — when
    present they enable the photometric stage."""

    base_id: torch.Tensor      # [id_dim, 3N]
    base_exp: torch.Tensor     # [exp_dim, 3N]
    mu: torch.Tensor           # [3N]
    sig_id: torch.Tensor       # [id_dim]
    sig_exp: torch.Tensor      # [exp_dim]
    keyinds: np.ndarray        # [68]
    left_contour: np.ndarray   # [8, K]
    right_contour: np.ndarray  # [8, K]
    base_tex: Optional[torch.Tensor] = None   # [tex_dim, 3N]
    mu_tex: Optional[torch.Tensor] = None     # [3N] in 0..255
    sig_tex: Optional[torch.Tensor] = None    # [tex_dim]
    tris: Optional[np.ndarray] = None         # [T, 3] vertex indices

    @staticmethod
    def load(modelpath: str, id_dim: int = 100, exp_dim: int = 79,
             tex_dim: int = 100, device=None) -> "Face3DMM":
        """The model on `device` ("cuda" unless named)."""
        from ..utils.device import resolve_device

        dev = resolve_device(device)
        info_p = os.path.join(modelpath, "3DMM_info.npy")
        keys_p = os.path.join(modelpath, "keys_info.npy")
        if not (os.path.exists(info_p) and os.path.exists(keys_p)):
            raise RuntimeError(
                f"3DMM assets not found in {modelpath}. The Basel Face Model "
                "is not redistributable; obtain 01_MorphableModel.mat + "
                "exp_info.npy and convert them (scripts/convert_bfm.py, "
                "mirroring the reference data_utils/face_tracking/"
                "convert_BFM.py), then place 3DMM_info.npy and keys_info.npy "
                "here.")
        info = np.load(info_p, allow_pickle=True).item()
        keys = np.load(keys_p, allow_pickle=True).item()
        mu = (info["mu_shape"] + info["mu_exp"]).reshape(-1, 3)
        mu = mu - mu.mean(0, keepdims=True)

        def t(v):
            return torch.as_tensor(np.asarray(v, np.float32), device=dev)

        def opt(key, scale=1.0, dims=None):
            if key not in info:
                return None
            v = np.asarray(info[key], np.float32)
            if dims is not None:
                v = v[:dims]
            return t(v * scale)

        return Face3DMM(
            base_id=t(np.asarray(info["b_shape"][:id_dim] / 1e5,
                                 np.float32)),
            base_exp=t(np.asarray(info["b_exp"][:exp_dim] / 1e5,
                                  np.float32)),
            mu=t(np.asarray(mu.reshape(-1) / 1e5, np.float32)),
            sig_id=t(info["sig_shape"][:id_dim]),
            sig_exp=t(info["sig_exp"][:exp_dim]),
            keyinds=np.asarray(keys["keyinds"], np.int64),
            left_contour=np.asarray(keys["left_contour"], np.int64),
            right_contour=np.asarray(keys["right_contour"], np.int64),
            base_tex=opt("b_tex", dims=tex_dim),
            mu_tex=opt("mu_tex"),
            sig_tex=opt("sig_tex", dims=tex_dim),
            tris=_load_tris(info, modelpath),
        )

    @property
    def device(self) -> torch.device:
        return self.mu.device

    @property
    def has_texture(self) -> bool:
        return (self.base_tex is not None and self.mu_tex is not None
                and self.tris is not None)

    def geometry(self, id_para: torch.Tensor, exp_para: torch.Tensor
                 ) -> torch.Tensor:
        """Full model-space vertices [B, N, 3] (facemodel.py forward_geo)."""
        idp = id_para * self.sig_id
        expp = exp_para * self.sig_exp
        g = idp @ self.base_id + expp @ self.base_exp + self.mu
        return g.reshape(g.shape[0], -1, 3)

    def albedo(self, tex_para: torch.Tensor) -> torch.Tensor:
        """Per-vertex albedo [N, 3] in [0, 1] (facemodel.py forward_tex)."""
        sig = self.sig_tex if self.sig_tex is not None else 1.0
        t = self.mu_tex + (tex_para * sig) @ self.base_tex
        return clip(t.reshape(-1, 3) / 255.0, 0.0, 1.0)

    def _sel(self, vert_ids: np.ndarray) -> torch.Tensor:
        v = np.asarray(vert_ids).reshape(-1)
        sel = np.stack([3 * v, 3 * v + 1, 3 * v + 2], -1).reshape(-1)
        return torch.as_tensor(sel, device=self.device)

    def landmarks_3d(self, id_para, exp_para, euler, trans, focal, cxy):
        """[B, 68, 3] model-space landmarks with contour snapping
        (facemodel.py:51-118)."""
        idp = id_para * self.sig_id
        expp = exp_para * self.sig_exp
        B = idp.shape[0]

        def geo(vsel):
            sel = self._sel(vsel)
            g = idp @ self.base_id[:, sel] + expp @ self.base_exp[:, sel] \
                + self.mu[sel]
            return g.reshape(B, -1, 3)

        npc = self.left_contour.shape[1]

        def contour(cset, take_max):
            g = geo(cset)                                    # [B, 8*npc, 3]
            proj_x = forward_transform(g, euler, trans, focal, cxy)[..., 0]
            proj_x = proj_x.reshape(B, 8, npc)
            arg = (torch.argmax if take_max else torch.argmin)(proj_x, dim=2)
            g = g.reshape(B, 8, npc, 3)
            return torch.gather(
                g, 2, arg[:, :, None, None].expand(B, 8, 1, 3))[:, :, 0]

        left = contour(self.left_contour, take_max=False)
        right = contour(self.right_contour, take_max=True)
        lands = geo(self.keyinds)                            # [B, 68, 3]
        return torch.cat([left, lands[:, 8:9], right, lands[:, 17:]], dim=1)


# ---------- photometric stage (render_3dmm.py + ajian_util.py:167-253, a
# differentiable point-splat in place of a triangle raster) ----------


def vertex_normals(verts: torch.Tensor, tris: np.ndarray) -> torch.Tensor:
    """Area-weighted vertex normals. verts [B, N, 3], tris [T, 3] ->
    [B, N, 3] unit normals (the raster normals of render_3dmm.py:120-140)."""
    t = torch.as_tensor(np.asarray(tris), device=verts.device)
    v0 = verts[:, t[:, 0]]
    v1 = verts[:, t[:, 1]]
    v2 = verts[:, t[:, 2]]
    fn = torch.cross(v1 - v0, v2 - v0, dim=-1)            # [B, T, 3]
    vn = torch.zeros_like(verts)
    for k in range(3):
        vn = vn.index_add(1, t[:, k], fn)
    norm = torch.sqrt(torch.sum(vn * vn, dim=-1, keepdim=True))
    return vn / torch.maximum(norm, norm.new_full((), 1e-8))


# 9-band SH constants (the standard Ramamoorthi/Hanrahan irradiance basis
# used by the reference's SHLights, render_3dmm.py:79-118)
_SH_A = np.array([np.pi, 2 * np.pi / np.sqrt(3.0), 2 * np.pi / np.sqrt(8.0)])
_SH_C = np.array([1 / np.sqrt(4 * np.pi),
                  np.sqrt(3.0) / np.sqrt(4 * np.pi),
                  3 * np.sqrt(5.0) / np.sqrt(12 * np.pi)])


def sh_irradiance(normals: torch.Tensor, gamma: torch.Tensor
                  ) -> torch.Tensor:
    """normals [B, N, 3], gamma [B, 9, 3] SH coefficients -> [B, N, 3]
    per-vertex RGB irradiance. gamma[:, 0] carries a +0.8 ambient offset
    (the reference's init_gamma=0.8)."""
    nx, ny, nz = normals[..., 0], normals[..., 1], normals[..., 2]
    a, c = _SH_A, _SH_C
    basis = torch.stack([
        torch.full_like(nx, float(a[0] * c[0])),
        -float(a[1] * c[1]) * ny,
        float(a[1] * c[1]) * nz,
        -float(a[1] * c[1]) * nx,
        float(a[2] * c[2]) * nx * ny,
        -float(a[2] * c[2]) * ny * nz,
        float(a[2] * c[2] / (2 * np.sqrt(3.0))) * (3 * nz ** 2 - 1),
        -float(a[2] * c[2]) * nx * nz,
        float(a[2] * c[2] / 2) * (nx ** 2 - ny ** 2),
    ], dim=-1)                                         # [B, N, 9]
    g = (torch.cat([gamma[:, :1] + 0.8, gamma[:, 1:]], dim=1)
         if gamma.ndim == 3 else gamma)
    return torch.einsum("bnk,bkc->bnc", basis, g)


def splat_render(proj: torch.Tensor, colors: torch.Tensor,
                 weights: torch.Tensor, H: int, W: int,
                 depth: Optional[torch.Tensor] = None,
                 depth_tau=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable point-splat: bilinear scatter-add of per-vertex colors.

    proj [B, N, 2] pixel coords (x, y), colors [B, N, 3], weights [B, N]
    (visibility/facing weights) -> (image [B, H, W, 3], wsum [B, H, W]).

    depth/depth_tau: `depth` [B, N] positive camera distances enable a SOFT
    Z-BUFFER — pass 1 scatter-mins the nearest contributing depth per
    pixel (no gradient), pass 2 multiplies each splat by
    exp(-(d - d_nearest)/tau) ([B] or scalar tau), so surfaces behind a
    nearer surface fade out smoothly."""
    B, N = proj.shape[:2]
    x = proj[..., 0]
    y = proj[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0

    corners = ((0, 0, (1 - fx) * (1 - fy)), (1, 0, fx * (1 - fy)),
               (0, 1, (1 - fx) * fy), (1, 1, fx * fy))

    def corner_idx(dx, dy):
        xi = clip(x0 + dx, 0, W - 1).to(torch.int32).long()
        yi = clip(y0 + dy, 0, H - 1).to(torch.int32).long()
        return (yi * W + xi).detach()                  # [B, N]

    occl = [1.0] * 4
    if depth is not None:
        tau = torch.as_tensor(depth_tau if depth_tau is not None else 1.0,
                              dtype=torch.float32, device=proj.device)
        tau = tau.expand(B) if tau.ndim == 0 else tau  # scalar or [B]
        with torch.no_grad():
            zsrc = torch.where(weights > 1e-6, depth,
                               depth.new_full((), 1e9))   # ignore back faces
            zbuf = depth.new_full((B, H * W), 1e9)
            for dx, dy, _ in corners:
                zbuf = zbuf.scatter_reduce(1, corner_idx(dx, dy), zsrc,
                                           "amin", include_self=True)
        occl = []
        for dx, dy, _ in corners:
            znear = torch.gather(zbuf, 1, corner_idx(dx, dy))   # [B, N]
            t = tau.reshape(B, 1)
            occl.append(torch.exp(
                -torch.maximum(depth - znear, depth.new_zeros(()))
                / torch.maximum(t, t.new_full((), 1e-6))))

    img = proj.new_zeros((B, H * W, 3))
    wsum = proj.new_zeros((B, H * W))
    for (dx, dy, w), oc in zip(corners, occl):
        idx = corner_idx(dx, dy)
        ww = w * weights * oc
        img = img.scatter_add(1, idx[..., None].expand(B, N, 3),
                              colors * ww[..., None])
        wsum = wsum.scatter_add(1, idx, ww)
    img = img / torch.maximum(wsum, wsum.new_full((), 1e-6))[..., None]
    return img.reshape(B, H, W, 3), wsum.reshape(B, H, W)


def render_photometric(model: Face3DMM, params: Dict, cxy, H: int, W: int,
                       scale: float = 1.0, depth_tau_rel: float = 0.05):
    """Forward photometric model: geometry -> normals -> SH shading ->
    depth-weighted point-splat. Returns (image [F, H', W', 3], wsum) at
    resolution/scale.

    depth_tau_rel: soft z-buffer temperature as a fraction of the model's
    per-frame depth range (0 disables: facing weights only)."""
    idb = params["id"].expand(params["exp"].shape[0],
                              params["id"].shape[-1])
    verts = model.geometry(idb, params["exp"])
    rot = euler2rot(params["euler"])
    verts_view = torch.einsum("bij,bnj->bni", rot, verts) \
        + params["trans"][:, None, :]
    normals = vertex_normals(verts, model.tris)
    normals_view = torch.einsum("bij,bnj->bni", rot, normals)
    # facing weight: the camera looks along -Z from the origin; front
    # faces have view-space normal z > 0
    facing = torch.relu(normals_view[..., 2])
    albedo = model.albedo(params["tex"])               # [N, 3]
    shade = sh_irradiance(normals_view, params["gamma"])
    colors = clip(albedo[None] * shade, 0.0, 1.0)

    X, Y, Z = verts_view[..., 0], verts_view[..., 1], verts_view[..., 2]
    px = (-params["focal"] * X / Z + cxy[0]) * scale
    py = (params["focal"] * Y / Z + cxy[1]) * scale
    proj = torch.stack([px, py], -1)
    h, w = int(round(H * scale)), int(round(W * scale))
    depth = tau = None
    if depth_tau_rel > 0:
        # positive camera distance is -Z; tau scales with the head's depth
        # extent
        depth = -Z
        rng_d = torch.amax(depth, dim=1) - torch.amin(depth, dim=1)
        tau = torch.maximum(depth_tau_rel * rng_d, rng_d.new_full((), 1e-6))
    return splat_render(proj, colors, facing, h, w, depth=depth,
                        depth_tau=tau)


class OptaxAdam:
    """optax.adam(lr) (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) in its own
    order of operations, over a list of tensors: mu = (1 - b1) g + b1 mu,
    nu = (1 - b2) g^2 + b2 nu, the bias corrections 1 - b^count computed
    in float32 (count from 1), u = mu_hat / (sqrt(nu_hat) + eps), then
    -lr * u. update() returns the updates, as optax's does."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, lr: float, params: Sequence[torch.Tensor]):
        self.lr = lr
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @staticmethod
    def _correction(decay: float, count: int) -> float:
        one = np.float32(1.0)
        return float(one - np.power(np.float32(decay), np.float32(count)))

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> list:
        self.count += 1
        bc1 = self._correction(self.b1, self.count)
        bc2 = self._correction(self.b2, self.count)
        out = []
        for i, g in enumerate(grads):
            self.mu[i] = (1 - self.b1) * g + self.b1 * self.mu[i]
            self.nu[i] = (1 - self.b2) * (g * g) + self.b2 * self.nu[i]
            u = (self.mu[i] / bc1) / (torch.sqrt(self.nu[i] / bc2)
                                      + self.eps)
            out.append(-self.lr * u)
        return out


def _photo_loss(model, p, cxy, photo_frames, photo_scale):
    ph = int(round(photo_frames.shape[1] / photo_scale))
    pw = int(round(photo_frames.shape[2] / photo_scale))
    img, wsum = render_photometric(model, p, cxy, ph, pw, photo_scale)
    cover = (wsum > 0.5).to(torch.float32)[..., None]
    return torch.sum(((img - photo_frames) ** 2) * cover) / \
        torch.clamp(torch.sum(cover), min=1.0)


def fit_light(model: Face3DMM, frames: torch.Tensor, cxy, params: Dict,
              scale: float = 0.25, tex_dim: Optional[int] = None,
              iters: int = 300, lr: float = 0.05,
              reg_tex: float = 0.05) -> Dict:
    """Photometric light/texture fit (ajian_util.py:167-253): holding the
    landmark-fit pose, optimize the shared texture code + per-frame SH gamma
    against the downscaled video frames. frames: [F, h, w, 3] float in
    [0, 1] ALREADY at the downscaled resolution (h = H*scale)."""
    if not model.has_texture:
        raise RuntimeError("photometric stage needs texture basis + topology "
                           "(b_tex/mu_tex/tris in 3DMM_info.npy)")
    F = params["exp"].shape[0]
    td = tex_dim or model.base_tex.shape[0]
    H = int(round(frames.shape[1] / scale))
    W = int(round(frames.shape[2] / scale))
    dev = params["exp"].device
    p = dict(params)
    p.setdefault("tex", torch.zeros((1, td), device=dev))
    p.setdefault("gamma", torch.zeros((F, 9, 3), device=dev))
    trainable = ("tex", "gamma")
    tp = {k: p[k] for k in trainable}
    frozen = {k: v for k, v in p.items() if k not in trainable}
    adam = OptaxAdam(lr, list(tp.values()))
    photo = torch.zeros((), device=dev)
    for _ in range(iters):
        leaves = [v.detach().requires_grad_() for v in tp.values()]
        q = {**frozen, **dict(zip(trainable, leaves))}
        img, wsum = render_photometric(model, q, cxy, H, W, scale)
        cover = (wsum > 0.5).to(torch.float32)[..., None]
        photo = torch.sum(((img - frames) ** 2) * cover) / \
            torch.clamp(torch.sum(cover), min=1.0)
        total = photo + reg_tex * torch.mean(q["tex"] ** 2)
        grads = torch.autograd.grad(total, leaves)
        ups = adam.update(grads)
        tp = {k: (v + u).detach()
              for (k, v), u in zip(zip(trainable, leaves), ups)}
    p.update(tp)
    p["photo_loss"] = float(photo.detach())
    return p


# ---------- fit stages (ajian_util.py ports) ----------

def _fit_step_for(model: Face3DMM, cxy, reg_id: float, reg_exp: float,
                  lap_w: float, photo_scale: float, photo_w: float):
    """The landmark (+ photometric) loss's Adam step for one loss
    configuration -> step(tp, frozen, adam, scale, lms, photo_frames) ->
    (tp, landmark loss). tp: the trainable tensors by name; the update is
    adam's (an OptaxAdam) times `scale` (the JAX step's post-scaling)."""

    def loss_fn(p, lms, photo_frames):
        F = lms.shape[0]
        idb = p["id"].expand(F, p["id"].shape[-1])
        geometry = model.landmarks_3d(idb, p["exp"], p["euler"], p["trans"],
                                      p["focal"], cxy)
        proj = forward_transform(geometry, p["euler"], p["trans"],
                                 p["focal"], cxy)
        loss = torch.mean((proj[..., :2] - lms) ** 2)
        total = loss
        if reg_id:
            total = total + reg_id * torch.mean(p["id"] ** 2)
        if reg_exp:
            total = total + reg_exp * torch.mean(p["exp"] ** 2)
        if lap_w:
            total = total + lap_w * (lap_loss_1d(p["euler"])
                                     + lap_loss_1d(p["trans"])
                                     + lap_loss_1d(p["exp"]))
        if photo_frames is not None and photo_w > 0:
            total = total + photo_w * _photo_loss(model, p, cxy,
                                                  photo_frames, photo_scale)
        return total, loss

    def step(tp, frozen, adam, scale, lms, photo_frames):
        names = list(tp)
        leaves = [tp[k].detach().requires_grad_() for k in names]
        total, lan = loss_fn({**frozen, **dict(zip(names, leaves))}, lms,
                             photo_frames)
        grads = torch.autograd.grad(total, leaves)
        ups = adam.update(grads)
        return ({k: (v + u * scale).detach()
                 for k, v, u in zip(names, leaves, ups)}, lan.detach())

    return step


def _adam_fit(model: Face3DMM, lms, cxy, params: Dict, trainable, iters: int,
              lr: float, reg_id: float = 0.0, reg_exp: float = 0.0,
              lap_w: float = 0.0, decay_at: Optional[int] = None,
              photo_frames: Optional[torch.Tensor] = None,
              photo_scale: float = 0.25, photo_w: float = 0.0):
    """Generic landmark-loss Adam loop; params: dict with id (shared
    [1, Did]), exp/euler/trans per-frame. Only keys in `trainable` get
    gradients; the update is scaled by 0.2 at every decay_at-th step. With
    photo_frames ([F, h, w, 3] downscaled video) and photo_w > 0 the loss
    adds the point-splat photometric term (ajian_util.py:255-488)."""
    step = _fit_step_for(model, cxy, reg_id, reg_exp, lap_w, photo_scale,
                         photo_w)
    if not (photo_frames is not None and photo_w > 0):
        photo_frames = None
    tp = {k: params[k] for k in trainable}
    frozen = {k: v for k, v in params.items() if k not in trainable}
    adam = OptaxAdam(lr, list(tp.values()))
    dev = lms.device
    scale = torch.ones((), device=dev)
    lan = torch.zeros((), device=dev)
    for i in range(iters):
        if decay_at and i and i % decay_at == 0:
            scale = scale * 0.2
        tp, lan = step(tp, frozen, adam, scale, lms, photo_frames)
    params.update(tp)
    return params, float(lan)


def _init_params(F: int, id_dim: int, exp_dim: int, focal: float,
                 device) -> Dict:
    trans = torch.zeros((F, 3), device=device)
    trans[:, 2] -= 7.0
    return {
        "id": torch.zeros((1, id_dim), device=device),
        "exp": torch.zeros((F, exp_dim), device=device),
        "euler": torch.zeros((F, 3), device=device),
        "trans": trans,
        "focal": torch.tensor(focal, dtype=torch.float32, device=device),
    }


# the reference's focal grid (ajian_util.py:28-92)
FOCAL_RANGE = tuple(range(600, 1500, 100))


def fit_focal(model: Face3DMM, lms_sel: torch.Tensor, cxy,
              id_dim: int = 100, exp_dim: int = 79,
              focal_range: Sequence[float] = FOCAL_RANGE,
              pose_iters: int = 2000, idexp_iters: int = 2500
              ) -> Tuple[float, float]:
    """Focal-length grid search on a frame subset (ajian_util.py:28-92).
    Returns (best_focal, best_landmark_loss); the best so far always wins."""
    best = (None, float("inf"))
    F = lms_sel.shape[0]
    for focal in focal_range:
        p = _init_params(F, id_dim, exp_dim, float(focal), lms_sel.device)
        p, _ = _adam_fit(model, lms_sel, cxy, p, ("euler", "trans"),
                         pose_iters, 0.1)
        p, lan = _adam_fit(model, lms_sel, cxy, p,
                           ("id", "exp", "euler", "trans"), idexp_iters, 0.1,
                           reg_id=0.5, reg_exp=0.4, decay_at=1500)
        if lan < best[1]:
            best = (float(focal), lan)
    return best


def fit_coarse(model: Face3DMM, lms: torch.Tensor, cxy, focal: float,
               id_dim: int = 100, exp_dim: int = 79) -> Dict:
    """Coarse all-frame fit (ajian_util.py:97-165)."""
    F = lms.shape[0]
    p = _init_params(F, id_dim, exp_dim, focal, lms.device)
    p, _ = _adam_fit(model, lms, cxy, p, ("euler", "trans"), 1500, 1.0,
                     decay_at=1000)
    p, lan = _adam_fit(model, lms, cxy, p, ("id", "exp", "euler", "trans"),
                       2000, 0.1, reg_id=0.5, reg_exp=0.4, decay_at=1000)
    return p


def save_params_npz(path: str, params: Dict) -> None:
    """A fit's parameters as an npz with the JAX package's keys (either
    package resumes from or reads the other's)."""
    np.savez(path, **{k: v.detach().cpu().numpy() if torch.is_tensor(v)
                      else np.asarray(v)
                      for k, v in params.items() if k != "photo_loss"})


def load_params_npz(path: str, device) -> Dict:
    """save_params_npz's file (or the JAX package's) as tensors on
    `device`; focal a float32 scalar."""
    data = np.load(path)
    out = {k: torch.as_tensor(np.asarray(data[k]), device=device)
           for k in data.files if k != "focal"}
    out["focal"] = torch.tensor(float(np.asarray(data["focal"])),
                                dtype=torch.float32, device=device)
    return out


def fit_fine(model: Face3DMM, lms: torch.Tensor, cxy, params: Dict,
             iters: int = 1000, lap_w: float = 0.05,
             resume_path: Optional[str] = None,
             save_every: int = 200,
             photo_frames: Optional[torch.Tensor] = None,
             photo_scale: float = 0.25,
             photo_w: float = 0.0) -> Dict:
    """Fine fit with laplacian temporal smoothing and (when photo_frames +
    tex/gamma params are present) the photometric color term
    (ajian_util.py:255-488). Checkpoints to `resume_path` (.npz, JAX's
    keys) every save_every steps and resumes from it when it exists."""
    if resume_path and os.path.exists(resume_path):
        params = {**params, **load_params_npz(resume_path, lms.device)}
    use_photo = (photo_frames is not None and photo_w > 0
                 and "tex" in params and "gamma" in params)
    trainable = ("exp", "euler", "trans") + (("gamma",) if use_photo else ())
    done = 0
    while done < iters:
        n = min(save_every, iters - done)
        params, _ = _adam_fit(
            model, lms, cxy, params, trainable, n, 0.01,
            reg_exp=0.2, lap_w=lap_w,
            photo_frames=photo_frames if use_photo else None,
            photo_scale=photo_scale, photo_w=photo_w if use_photo else 0.0)
        done += n
        if resume_path:
            save_params_npz(resume_path, params)
    return params


def track_video(ori_dir: str, base_dir: str, modelpath: str,
                sel_num: int = 25, photometric: bool = True,
                photo_scale: float = 0.25, photo_w: float = 0.5,
                device=None, log=None) -> Dict:
    """The whole tracker (face_tracker.py:24-132) on `device` ("cuda"
    unless named): load .lms files, focal search on a subset, coarse fit,
    photometric light/texture fit (when the BFM texture assets are
    present), fine fit; save track_params.npz (JAX's keys) and
    track_params.pt. log(stage, seconds): called after each stage."""
    import glob
    import time

    import cv2

    from ..utils.device import resolve_device

    dev = resolve_device(device)

    def stage(name, t0):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if log is not None:
            log(name, time.perf_counter() - t0)
        return time.perf_counter()

    lms_files = sorted(glob.glob(os.path.join(ori_dir, "*.lms")),
                       key=lambda p: int(os.path.basename(p).split(".")[0]))
    lms = torch.as_tensor(np.stack([np.loadtxt(p) for p in lms_files]),
                          dtype=torch.float32, device=dev)     # [F, 68, 2]
    img = cv2.imread(lms_files[0].replace(".lms", ".jpg"))
    h, w = img.shape[:2]
    cxy = (w / 2.0, h / 2.0)

    model = Face3DMM.load(modelpath, device=dev)
    F = lms.shape[0]
    sel = np.arange(0, F, max(1, F // sel_num))[:sel_num]
    t0 = time.perf_counter()
    focal, landis = fit_focal(model, lms[torch.as_tensor(sel, device=dev)],
                              cxy)
    t0 = stage("focal", t0)
    params = fit_coarse(model, lms, cxy, focal)
    t0 = stage("coarse", t0)

    photo_frames = None
    if photometric and model.has_texture:
        hw = (int(round(h * photo_scale)), int(round(w * photo_scale)))
        frames = [cv2.resize(
            cv2.cvtColor(cv2.imread(p.replace(".lms", ".jpg")),
                         cv2.COLOR_BGR2RGB), (hw[1], hw[0]))
            for p in lms_files]
        photo_frames = torch.as_tensor(np.stack(frames), dtype=torch.float32,
                                       device=dev) / 255.0
        params = fit_light(model, photo_frames, cxy, params,
                           scale=photo_scale)
        t0 = stage("light", t0)
    params = fit_fine(model, lms, cxy, params,
                      resume_path=os.path.join(base_dir,
                                               "track_iter_params.npz"),
                      photo_frames=photo_frames, photo_scale=photo_scale,
                      photo_w=photo_w)
    stage("fine", t0)

    # trans is saved in tracker units; save_transforms divides by 10
    # (process.py:327), as with the reference's track_params.pt
    def host(k):
        return params[k].detach().cpu().numpy()

    out = {"focal": np.asarray([float(params["focal"])], np.float32),
           "euler": host("euler"), "trans": host("trans"),
           "exp": host("exp"), "id": host("id")}
    np.savez(os.path.join(base_dir, "track_params.npz"), **out)
    torch.save({k: torch.as_tensor(v) for k, v in out.items()},
               os.path.join(base_dir, "track_params.pt"))
    return out
