"""Reference checkpoint interchange (port of lzzx_nerf_tpu/utils/convert.py):
the reference's ['model'] state dict (nerf_triplane/network.py) to and
from the state dicts of the port's modules.

The hash-encoder NeRFField and the tiled TorsoField hold the reference's
parameter tensors in the reference's own layouts, so a conversion renames
keys and keeps every tensor's bytes:

  reference                               port
  audio_net.encoder_conv.{0,2,4,6}.*      audio_net.Conv_{0..3}.*  (Conv1d [out, in, k])
  audio_net.encoder_fc1.{0,2}.*           audio_net.Dense_{0,1}.*  (Linear [out, in])
  audio_att_net.attentionConvNet.{0..8}.* audio_att_net.Conv_{0..4}.*
  audio_att_net.attentionNet.0.*          audio_att_net.Dense_0.*
  <mlp>.net.<l>.weight                    <mlp>.net_<l>.weight
  encoder_<plane>.embeddings [rows, 1]    encoder_<plane>
  torso_encoder.embeddings [rows, 2]      torso_encoder
  individual_codes, individual_codes_torso, anchor_points (as they are)
  embedding.weight [V, V]                 embedding.weight (label audio, --emb)

Use NeRFField(encoder="hash") and TorsoField(encoder="tiled") with
converted checkpoints (the dense encoders have their own parameterisation
and train from scratch).
"""

from __future__ import annotations

from typing import Dict

import torch

HEAD_MLPS = (("sigma_net", 3), ("color_net", 2), ("unc_net", 2),
             ("aud_ch_att_net", 2), ("eye_att_net", 2))
TORSO_MLPS = (("torso_deform_net", 3), ("torso_net", 3))
PLANES = ("xy", "yz", "xz")

# reference layer index -> the port's layer name, per audio module
_AUDIO = (("audio_net.encoder_conv", (0, 2, 4, 6), "audio_net.Conv"),
          ("audio_net.encoder_fc1", (0, 2), "audio_net.Dense"))
_AUDIO_ATT = (("audio_att_net.attentionConvNet", (0, 2, 4, 6, 8),
               "audio_att_net.Conv"),
              ("audio_att_net.attentionNet", (0,), "audio_att_net.Dense"))


def _tensor(v) -> torch.Tensor:
    """A state dict value (tensor or array) as a CPU tensor, its dtype and
    bytes kept."""
    return torch.as_tensor(v).detach().cpu()


def _key_map(head: bool, att: bool) -> Dict[str, str]:
    """reference key -> port key of the head's (with the audio attention
    net when att) or the torso's tensors."""
    out = {}
    if head:
        for ref, layers, port in _AUDIO + (_AUDIO_ATT if att else ()):
            for i, lyr in enumerate(layers):
                for p in ("weight", "bias"):
                    out[f"{ref}.{lyr}.{p}"] = f"{port}_{i}.{p}"
        for name, n in HEAD_MLPS:
            for lyr in range(n):
                out[f"{name}.net.{lyr}.weight"] = f"{name}.net_{lyr}.weight"
        for p in PLANES:
            out[f"encoder_{p}.embeddings"] = f"encoder_{p}"
        out["individual_codes"] = "individual_codes"
        out["embedding.weight"] = "embedding.weight"
    else:
        for name, n in TORSO_MLPS:
            for lyr in range(n):
                out[f"{name}.net.{lyr}.weight"] = f"{name}.net_{lyr}.weight"
        out["torso_encoder.embeddings"] = "torso_encoder"
        out["anchor_points"] = "anchor_points"
        out["individual_codes_torso"] = "individual_codes_torso"
    return out


def _has_att(keys) -> bool:
    return any(k.startswith("audio_att_net.") for k in keys)


# tensors a reference state dict holds only for some models: the codes,
# the label embedding (emb) and the eye branch (exp_eye)
_OPTIONAL = ("individual_codes", "embedding.", "eye_att_net.")


def _convert(sd: Dict, head: bool) -> Dict[str, torch.Tensor]:
    keys = _key_map(head, _has_att(sd))
    missing = [k for k in keys if k not in sd
               and not k.startswith(_OPTIONAL)]
    if missing:
        raise KeyError(f"reference state dict lacks {missing}")
    return {port: _tensor(sd[ref]) for ref, port in keys.items()
            if ref in sd}


def convert_reference_state_dict(sd: Dict) -> Dict[str, torch.Tensor]:
    """The reference checkpoint's ['model'] state dict (tensors or arrays;
    keys it does not map, such as the density grid, are ignored) -> a
    state dict of NeRFField(encoder="hash"). individual_codes, the audio
    attention net, the label embedding (a model trained with emb) and
    eye_att_net (absent from a model trained without exp_eye) are
    carried when present; any other missing tensor raises KeyError. The
    JAX package's converter requires eye_att_net and drops the
    embedding."""
    return _convert(sd, head=True)


def convert_reference_torso(sd: Dict) -> Dict[str, torch.Tensor]:
    """The torso's tensors of a reference state dict -> a state dict of
    TorsoField(encoder="tiled")."""
    return _convert(sd, head=False)


def _export(state_dict: Dict, head: bool) -> Dict[str, torch.Tensor]:
    inverse = {port: ref for ref, port in _key_map(
        head, _has_att(state_dict)).items()}
    out = {}
    for name, v in state_dict.items():
        ref = inverse.get(name)
        if ref is not None:
            out[ref] = _tensor(v).clone()
    return out


def export_reference_state_dict(state_dict: Dict) -> Dict[str, torch.Tensor]:
    """Inverse of convert_reference_state_dict: a NeRFField(encoder="hash")
    state dict -> the reference's ['model'] layout (CPU tensors; save with
    torch.save under "model" for a .pth the reference loads). Parameters
    the reference has no counterpart of (camera_dR, camera_dT) are left
    out, and a missing eye_att_net is tolerated, as the reference's loader
    tolerates it."""
    return _export(state_dict, head=True)


def export_reference_torso(state_dict: Dict) -> Dict[str, torch.Tensor]:
    """Inverse of convert_reference_torso."""
    return _export(state_dict, head=False)


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Load a reference .pth file and convert its head's parameters."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return convert_reference_state_dict(ckpt.get("model", ckpt))
