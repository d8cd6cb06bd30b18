from .audio import AudioAttNet, AudioNet
from .mlp import MLP
from .nerf import FieldOutputs, NeRFField, TorsoField, make_fused_apply

__all__ = ["AudioAttNet", "AudioNet", "FieldOutputs", "MLP", "NeRFField",
           "TorsoField", "make_fused_apply"]
