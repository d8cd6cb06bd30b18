"""Triplane audio-conditioned NeRF field + torso model (port of
lzzx_nerf_tpu/models/nerf.py): the head field's and the torso's
training forwards and the serving subset.

Parameters are named like the flax params tree (encoder_xy_l0,
sigma_net.net_0.weight, audio_net.Conv_0.weight, ...), so
``module.load_state_dict(params_from_jax(tree))`` loads a JAX checkpoint
(serving/state_io.py). Two encoders each: the head's "dense"
(corner-packed triplane, the trained state's and the serving default) and
"hash" (the reference's instant-ngp hash triplane, ops/grid.py: what a
reference checkpoint holds, utils/convert.py); the torso's "dense" and
"tiled" (the reference's tiled grid)."""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..ops import fused_field as ff
from ..ops.freq import freq_encode
from ..ops.grid import GridSpec, grid_encode, make_grid_spec
from ..ops.packed_triplane import (DenseTriplaneSpec, bake_packed,
                                   dense_triplane_encode, encode_triplanes)
from ..ops.sh import sh_encode
from ..utils.clip import clip
from .audio import AudioAttNet, AudioNet
from .mlp import MLP

PLANES = ("xy", "yz", "xz")
HEAD_ENCODERS = ("dense", "hash")
TORSO_ENCODERS = ("dense", "tiled")
# the torso's anchor points at initialisation (the JAX TorsoField's)
ANCHOR_POINTS = ((0.01, 0.01, 0.1, 1.0), (-0.1, -0.1, 0.1, 1.0),
                 (0.1, -0.1, 0.1, 1.0))


class DensityOutputs(NamedTuple):
    sigma: torch.Tensor        # [N]
    geo_feat: torch.Tensor     # [N, 64]
    ambient_aud: torch.Tensor  # [N]  ||aud channel attention||_2
    ambient_eye: torch.Tensor  # [N]  eye attention (sigmoid)


class FieldOutputs(NamedTuple):
    sigma: torch.Tensor        # [N]
    color: torch.Tensor        # [N, 3]
    ambient_aud: torch.Tensor  # [N]
    ambient_eye: torch.Tensor  # [N]
    uncertainty: torch.Tensor  # [N]  softplus-activated


class _Logistic(torch.autograd.Function):
    """lax.logistic in a reduced precision, as XLA computes it: 1 / (1 +
    exp(-x)) with every operation rounded to x's dtype (torch.sigmoid
    rounds once), and its JVP rule g * (y * (1 - y))."""

    @staticmethod
    def forward(ctx, x):
        y = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (y * (1 - y))


def triplane_spec(bound: float) -> GridSpec:
    """The hash head's grid of each plane (reference network.py:131-133):
    12 levels x 1 channel, base 64, 2^14 rows, to 512 x bound."""
    return make_grid_spec(
        input_dim=2, num_levels=12, level_dim=1, base_resolution=64,
        log2_hashmap_size=14, desired_resolution=512 * bound,
        gridtype="hash")


def torso_tiled_spec() -> GridSpec:
    """The tiled torso's grid (reference network.py:166): 16 levels x 2
    channels, base 16, 2^16 rows, to 2048."""
    return make_grid_spec(
        input_dim=2, num_levels=16, level_dim=2, base_resolution=16,
        log2_hashmap_size=16, desired_resolution=2048, gridtype="tiled")


def _plane_coords(xyz: torch.Tensor):
    """The (xy, yz, xz) projections of points [N, 3]."""
    return (xyz[:, :2], xyz[:, 1:],
            torch.cat([xyz[:, :1], xyz[:, 2:]], dim=-1))


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x) if x.dtype == torch.float32 else \
        _Logistic.apply(x)


class NeRFField(nn.Module):
    def __init__(self, bound: float = 1.0, audio_in_dim: int = 1024,
                 audio_dim: int = 32, att: int = 2, ind_dim: int = 4,
                 ind_num: int = 10_000, camera_frames: int = 0,
                 dtype: torch.dtype = torch.float32, encoder: str = "dense",
                 exp_eye: bool = True, emb: bool = False):
        """encoder: "dense" (tables encoder_{xy,yz,xz}_l{0..3}) or "hash"
        (tables encoder_xy, encoder_yz, encoder_xz [total rows, 1] of
        triplane_spec(bound)).

        exp_eye: the eye branch (eye_att_net, and the eye column of
        sigma_net's first layer); without it the density is a function of
        the encoding and the audio alone, as in the JAX field, whose
        parameter tree then has no eye_att_net. emb: the audio features
        are labels, looked up in an embedding [audio_in_dim,
        audio_in_dim] before the audio net (the JAX field's nn.Embed).

        camera_frames > 0: the learned per-frame pose refinement
        (train_camera) as parameters camera_dR (Euler degrees) and
        camera_dT [camera_frames, 3], zero at initialisation.

        dtype: the compute dtype of the audio nets and the MLPs (the flax
        field's `dtype`; the CLI passes bfloat16 under --fp16). The
        parameters stay float32; density and forward follow JAX's dtype
        promotions (a float32 operand promotes a bfloat16 one)."""
        super().__init__()
        self.dtype = dtype
        self.bound = bound
        self.audio_dim = audio_dim
        self.att = att
        self.ind_dim = ind_dim
        if encoder not in HEAD_ENCODERS:
            raise ValueError(f"unknown head encoder {encoder!r}")
        self.encoder = encoder
        self.dense_spec = DenseTriplaneSpec()
        if encoder == "dense":
            spec = self.dense_spec
            for p in PLANES:
                for lvl, (r, c) in enumerate(zip(spec.resolutions,
                                                 spec.channels)):
                    self.register_parameter(
                        f"encoder_{p}_l{lvl}",
                        nn.Parameter(torch.zeros(r + 1, r + 1, c)))
            in_dim = 3 * spec.output_dim                   # 36
        else:
            self.spec = triplane_spec(bound)
            for p in PLANES:
                self.register_parameter(f"encoder_{p}", nn.Parameter(
                    torch.zeros(self.spec.total_params,
                                self.spec.level_dim)))
            in_dim = 3 * self.spec.output_dim              # 36
        self.in_dim = in_dim
        self.exp_eye = exp_eye
        self.emb = emb
        if emb:
            self.embedding = nn.Embedding(audio_in_dim, audio_in_dim)
        self.audio_net = AudioNet(audio_in_dim, audio_dim, dtype=dtype)
        if att > 0:
            self.audio_att_net = AudioAttNet(audio_dim, dtype=dtype)
        if exp_eye:
            self.eye_att_net = MLP(in_dim, 1, 16, 2, dtype=dtype)
        self.sigma_net = MLP(in_dim + audio_dim + int(exp_eye), 1 + 64, 64, 3,
                             dtype=dtype)
        self.color_net = MLP(16 + 64 + ind_dim, 3, 64, 2, dtype=dtype)
        self.unc_net = MLP(in_dim, 1, 32, 2, dtype=dtype)
        self.aud_ch_att_net = MLP(in_dim, audio_dim, 64, 2, dtype=dtype)
        if ind_dim > 0:
            self.individual_codes = nn.Parameter(
                torch.zeros(ind_num, ind_dim))
        if camera_frames > 0:
            self.camera_dR = nn.Parameter(torch.zeros(camera_frames, 3))
            self.camera_dT = nn.Parameter(torch.zeros(camera_frames, 3))

    def plane_levels(self, p: str):
        return [getattr(self, f"encoder_{p}_l{lvl}")
                for lvl in range(len(self.dense_spec.resolutions))]

    @torch.no_grad()
    def bake_tables(self, dtype=torch.float32) -> Dict[str, torch.Tensor]:
        """Corner-packed lookup tables for the three planes (once per model
        load; baked in f32 and cast to `dtype` once); {} for the hash
        encoder, which has none."""
        if self.encoder != "dense":
            return {}
        return {p: bake_packed(self.plane_levels(p), self.dense_spec,
                               dtype=dtype) for p in PLANES}

    def bake_train_tables(self) -> Dict[str, torch.Tensor]:
        """The float32 packed tables baked inside the autograd graph: the
        training forward's encoding (the JAX field's in-graph bake), whose
        gradient reaches the plane parameters; {} for the hash encoder."""
        if self.encoder != "dense":
            return {}
        return {p: bake_packed(self.plane_levels(p), self.dense_spec)
                for p in PLANES}

    def encode_x(self, xyz: torch.Tensor,
                 packed: Optional[Dict[str, torch.Tensor]] = None,
                 interp_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """[N, 3] in [-bound, bound] -> [N, 36] triplane features. dense:
        from the packed tables (baked here in the graph when None); hash:
        grid_encode of each plane's table (packed is ignored). A
        reduced-precision interp_dtype is refused: the port's encodings are
        float32 (the JAX hash encoder refuses it too)."""
        if interp_dtype != torch.float32:
            raise ValueError(
                f"interp_dtype {interp_dtype} is not supported: the "
                f"{self.encoder} encoder interpolates in float32")
        if self.encoder == "dense":
            return encode_triplanes(
                xyz, self.bake_train_tables() if packed is None else packed,
                self.dense_spec, self.bound)
        tables = (self.encoder_xy, self.encoder_yz, self.encoder_xz)
        return torch.cat([grid_encode(c, t, self.spec, self.bound)
                          for c, t in zip(_plane_coords(xyz), tables)],
                         dim=-1)

    def encode_audio_train(self, a: torch.Tensor) -> torch.Tensor:
        """a: [n_frames, T, C_in] (8 frames when att > 0; with emb the
        labels [n_frames, T], truncated to integers like the JAX field's
        astype(int32)) -> [1, audio_dim], with gradients (the training
        step's audio path)."""
        if self.emb:
            a = self.embedding(a.to(torch.int64))
        enc = self.audio_net(a)
        if self.att > 0:
            enc = self.audio_att_net(enc[None])
        return enc

    @torch.no_grad()
    def encode_audio(self, a: torch.Tensor) -> torch.Tensor:
        """encode_audio_train without gradients (the serving path)."""
        return self.encode_audio_train(a)

    def density(self, x: torch.Tensor, enc_a: torch.Tensor,
                e: Optional[torch.Tensor],
                enc_x: Optional[torch.Tensor] = None,
                packed: Optional[Dict[str, torch.Tensor]] = None
                ) -> DensityOutputs:
        """sigma (plain exp), geometry features and the two ambient
        attentions of points x [N, 3], at eye value e [1]. Without the eye
        branch (exp_eye False) or eye value (e None) the eye attention is
        0 and sigma_net reads no eye column, as in the JAX field."""
        if enc_x is None:
            enc_x = self.encode_x(x, packed)
        N = enc_x.shape[0]
        enc_a = enc_a.reshape(1, -1).expand(N, self.audio_dim)
        aud_ch_att = self.aud_ch_att_net(enc_x)
        enc_w = enc_a * aud_ch_att
        if self.exp_eye and e is not None:
            eye_att = _sigmoid(self.eye_att_net(enc_x))            # [N, 1]
            # under bfloat16 compute the float32 encoding and eye value
            # promote the concatenation to float32; sigma_net casts it back
            h = self.sigma_net(torch.cat(
                [enc_x, enc_w, e.reshape(1, 1) * eye_att], dim=-1))
        else:
            eye_att = enc_x.new_zeros((N, 1))
            h = self.sigma_net(torch.cat([enc_x, enc_w], dim=-1))
        # plain exp is the reference activation (not trunc_exp)
        sigma = torch.exp(h[..., 0].float())
        # safe L2: the plain norm's gradient at an exactly-zero vector is
        # nan, and the ambient-audio loss drives these outputs to zero
        amb_aud = torch.sqrt(torch.sum(aud_ch_att ** 2, dim=-1) + 1e-12)
        return DensityOutputs(sigma, h[..., 1:], amb_aud, eye_att[..., 0])

    def forward(self, x: torch.Tensor, d: torch.Tensor, enc_a: torch.Tensor,
                c: Optional[torch.Tensor], e: Optional[torch.Tensor],
                compute_uncertainty: bool = True,
                packed: Optional[Dict[str, torch.Tensor]] = None
                ) -> FieldOutputs:
        """The training field: points x [N, 3], unit view dirs d [N, 3],
        audio code enc_a [1, audio_dim], individual code c [ind_dim] or
        None, eye value e [1] (None, or ignored, without the eye branch).
        packed: the step's tables
        (bake_train_tables), baked here when None."""
        enc_x = self.encode_x(x, packed)
        dens = self.density(x, enc_a, e, enc_x)
        parts = [sh_encode(d, 4), dens.geo_feat]
        if c is not None:
            parts.append(c.reshape(1, -1).expand(x.shape[0], c.numel()))
        h_color = self.color_net(torch.cat(parts, dim=-1)).float()
        color = torch.sigmoid(h_color) * (1 + 2 * 0.001) - 0.001
        if compute_uncertainty:
            # unc_net sees a detached encoding
            unc = F.softplus(self.unc_net(enc_x.detach()).float())[..., 0]
        else:
            unc = torch.zeros_like(dens.sigma)
        return FieldOutputs(dens.sigma, color, dens.ambient_aud,
                            dens.ambient_eye, unc)

    def init_all(self, x, d, auds, c, e) -> FieldOutputs:
        """Runs every submodule once (the JAX field's init_all)."""
        return self(x, d, self.encode_audio_train(auds), c, e)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "NeRFField":
        """Draw every parameter from `generator` with the JAX package's
        initialisers: triplane tables uniform in ±1e-4, individual codes
        normal x 0.1, kernels torch_linear_init (uniform in
        ±1/sqrt(shape[0]) of the flax kernel: its fan-in for a Dense,
        the kernel width 3 for a Conv), biases zero, the label embedding
        normal with variance 1 / width (flax's nn.Embed default, untruncated
        here). Returns self."""
        for name, p in self.named_parameters():
            if name in ("camera_dR", "camera_dT"):
                continue
            if name == "embedding.weight":
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=p.device) / math.sqrt(p.shape[1]))
                continue
            if name.startswith("encoder_"):
                bound = 1e-4
            elif name == "individual_codes":
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=p.device) * 0.1)
                continue
            elif name.endswith(".bias"):
                p.zero_()
                continue
            elif p.ndim == 3:                 # Conv1d [out, in, k]
                bound = 1.0 / math.sqrt(p.shape[2])
            else:                             # Linear [out, in]
                bound = 1.0 / math.sqrt(p.shape[1])
            u = torch.rand(p.shape, generator=generator, device=p.device)
            p.copy_((u * 2.0 - 1.0) * bound)
        return self


def make_fused_apply(field: NeRFField, packed: Dict[str, torch.Tensor],
                     enc_a: torch.Tensor, ind_code: Optional[torch.Tensor],
                     eye, use_kernel: bool = True
                     ) -> Callable[[torch.Tensor, torch.Tensor],
                                   Tuple[torch.Tensor, torch.Tensor]]:
    """The serving field for one frame: (pts [N, 3], dirs [N, 3]) ->
    (sigma [N], color [N, 3]) through the folded-weight decomposition
    (ops/fused_field.py). The frame's audio code, individual code and eye
    value fold into the weights here, once per frame.

    use_kernel=True runs the field kernel's wrapper (the CUDA kernel on a
    CUDA device, its plain version on the CPU): for the dense encoder's
    bf16 tables (the serving default) fused_field_eval (the triplane
    lookup, the SH basis and the MLP stack in the kernel); for float32
    tables (infer_table_bf16 off) and for the hash encoder, the encoding
    in plain PyTorch (packed_lookup over the f32 tables, or grid_encode)
    and then fused_field_enc_eval (the kernel's entry that reads enc_x),
    as the JAX package looks up outside its Pallas kernel. False runs the
    plain version on any device — the reference the kernel is held to
    (the JAX package's --fused 1). A field without the eye branch has
    zero eye weights here (extract_field_weights), so its eye term is 0."""
    fw = ff.fold_frame_weights(ff.extract_field_weights(field), enc_a,
                               ind_code, eye)
    # the kernel's weight vector, once per frame
    wpack = (ff.pack_frame_weights(fw)
             if use_kernel and fw.sig1.device.type == "cuda" else None)
    enc_entry = field.encoder == "hash" or any(
        t.dtype != torch.bfloat16 for t in packed.values())

    @torch.no_grad()
    def apply(pts, dirs):
        # looked up in the module at each call, so a caller can wrap them
        if enc_entry:
            enc_x = field.encode_x(pts.float(), packed or None)
            if use_kernel:
                return ff.fused_field_enc_eval(fw, enc_x, dirs, wpack)
            out = ff.fused_field_reference(fw, enc_x,
                                           sh_encode(dirs.float(), 4))
        elif use_kernel:
            return ff.fused_field_eval(fw, pts, dirs, packed,
                                       field.dense_spec, field.bound, wpack)
        else:
            out = ff.field_reference(fw, pts, dirs, packed,
                                     field.dense_spec, field.bound)
        return out[:, 0], out[:, 1:4]

    return apply


class TorsoField(nn.Module):
    """2-D deformation-field torso model (port of the JAX TorsoField): the
    serving forward, and the training forward (train_forward). encoder
    "dense": the corner-packed table (torso_encoder_l{0..3}), baked once
    for serving or in the autograd graph for training; "tiled": the
    reference's 16-level tiled grid (torso_encoder [555,520, 2],
    grid_encode), which has no bake."""

    def __init__(self, torso_shrink: float = 0.8, ind_dim_torso: int = 8,
                 ind_num: int = 10_000, encoder: str = "dense"):
        super().__init__()
        if encoder not in TORSO_ENCODERS:
            raise ValueError(f"unknown torso encoder {encoder!r}")
        self.encoder = encoder
        self.torso_shrink = torso_shrink
        self.dense_spec = DenseTriplaneSpec()
        self.anchor_points = nn.Parameter(torch.tensor(ANCHOR_POINTS))
        if encoder == "dense":
            spec = self.dense_spec
            for lvl, (r, c) in enumerate(zip(spec.resolutions,
                                             spec.channels)):
                self.register_parameter(
                    f"torso_encoder_l{lvl}",
                    nn.Parameter(torch.zeros(r + 1, r + 1, c)))
            feat_dim = spec.output_dim                          # 12
        else:
            self.spec = torso_tiled_spec()
            self.torso_encoder = nn.Parameter(torch.zeros(
                self.spec.total_params, self.spec.level_dim))
            feat_dim = self.spec.output_dim                     # 32
        # in dims: freq(2, deg 8) = 34 + freq(6, deg 3) = 42 + ind
        h_dim = 34 + 42 + ind_dim_torso
        self.torso_deform_net = MLP(h_dim, 2, 32, 3)
        self.torso_net = MLP(feat_dim + h_dim, 4, 32, 3)
        if ind_dim_torso > 0:
            self.individual_codes_torso = nn.Parameter(
                torch.zeros(ind_num, ind_dim_torso))

    def levels(self):
        return [getattr(self, f"torso_encoder_l{lvl}")
                for lvl in range(len(self.dense_spec.resolutions))]

    @torch.no_grad()
    def bake_table(self, dtype=torch.float32) -> Optional[torch.Tensor]:
        """The serving table; None for the tiled encoder."""
        if self.encoder != "dense":
            return None
        return bake_packed(self.levels(), self.dense_spec, dtype=dtype)

    def bake_train_table(self) -> Optional[torch.Tensor]:
        """The float32 packed table baked inside the autograd graph (the
        JAX TorsoField's in-graph bake); None for the tiled encoder."""
        if self.encoder != "dense":
            return None
        return bake_packed(self.levels(), self.dense_spec)

    def _encode(self, xd: torch.Tensor, packed: Optional[torch.Tensor]
                ) -> torch.Tensor:
        """The grid features of the deformed coords xd [N, 2]: the dense
        table's lookup (packed, baked in the graph when None) or the tiled
        grid's encoding."""
        if self.encoder == "dense":
            if packed is None:
                packed = self.bake_train_table()
            return dense_triplane_encode(packed, xd, self.dense_spec,
                                         bound=1.0)
        return grid_encode(xd, self.torso_encoder, self.spec, bound=1.0)

    def _deform_inputs(self, x, pose, c, inv_pose_t):
        """The shrunk coords [N, 2] and the deform/torso nets' shared input
        h [N, 84]: freq(x, 8), freq of the anchors projected through the
        inverse transposed pose (3), and the individual code."""
        N = x.shape[0]
        x = x * self.torso_shrink
        if inv_pose_t is None:
            # inv_ex: no host check of the result (a step makes no sync)
            inv_pose_t = torch.linalg.inv_ex(pose.T).inverse
        wrapped = self.anchor_points @ inv_pose_t               # [3, 4]
        wrapped = (wrapped[:, :2] / wrapped[:, 3:4]
                   / wrapped[:, 2:3]).reshape(1, -1)
        enc_anchor = freq_encode(wrapped, 3)                    # [1, 42]
        enc_x = freq_encode(x, 8)                               # [N, 34]
        parts = [enc_x, enc_anchor.expand(N, -1)]
        if c is not None:
            parts.append(c.reshape(1, -1).expand(N, -1))
        return x, torch.cat(parts, dim=-1)

    def _outputs(self, feat, h):
        h = self.torso_net(torch.cat([feat, h], dim=-1))
        alpha = torch.sigmoid(h[..., :1]) * (1 + 2 * 0.001) - 0.001
        color = torch.sigmoid(h[..., 1:]) * (1 + 2 * 0.001) - 0.001
        return alpha, color

    @torch.no_grad()
    def forward(self, x: torch.Tensor, pose: torch.Tensor,
                c: Optional[torch.Tensor],
                packed: Optional[torch.Tensor] = None,
                inv_pose_t: Optional[torch.Tensor] = None):
        """x [N, 2] in [-1, 1] screen coords, pose [4, 4] head c2w ->
        (alpha [N, 1], color [N, 3], dx [N, 2]). packed: the dense
        encoder's serving table (bake_table; None for the tiled encoder).
        inv_pose_t: the inverse of pose.T when the caller has it
        (torch.linalg.inv checks its result on the host, so a CUDA graph
        takes it as an input)."""
        x, h = self._deform_inputs(x, pose, c, inv_pose_t)
        dx = self.torso_deform_net(h)
        xd = torch.clamp(x + dx, -1.0, 1.0)
        return (*self._outputs(self._encode(xd, packed), h), dx)

    def train_forward(self, x: torch.Tensor, pose: torch.Tensor,
                      c: Optional[torch.Tensor],
                      packed: Optional[torch.Tensor] = None):
        """forward with gradients (the JAX TorsoField.__call__): the table
        baked in the graph unless `packed` (bake_train_table) is given, and
        jnp.clip's half gradient where x + dx lands on ±1."""
        x, h = self._deform_inputs(x, pose, c, None)
        dx = self.torso_deform_net(h)
        xd = clip(x + dx, -1.0, 1.0)
        return (*self._outputs(self._encode(xd, packed), h), dx)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "TorsoField":
        """Draw the parameters from `generator` with the JAX TorsoField's
        initialisers: tables uniform in ±1e-4, individual codes normal x
        0.1, kernels torch_linear_init (uniform in ±1/sqrt(fan-in)), the
        anchor points fixed. Returns self."""
        for name, p in self.named_parameters():
            if name == "anchor_points":
                p.copy_(torch.tensor(ANCHOR_POINTS))
                continue
            if name == "individual_codes_torso":
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=p.device) * 0.1)
                continue
            bound = (1e-4 if name.startswith("torso_encoder")
                     else 1.0 / math.sqrt(p.shape[1]))
            u = torch.rand(p.shape, generator=generator, device=p.device)
            p.copy_((u * 2.0 - 1.0) * bound)
        return self
