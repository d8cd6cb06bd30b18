"""Audio front-ends: the wav2lip mel spectrogram and the HuBERT feature
extractor (gated: it needs `transformers` and the pretrained weights)."""

from .hubert import HubertFeatureExtractor, HubertStreamer  # noqa: F401
from .mel import MelParams, melspectrogram, wav_to_mel_chunks  # noqa: F401
