from stt_tpu_torch.frontend.features import (
    FeatureConfig,
    audio_to_mfcc,
    audio_to_mfcc_numpy,
    mfcc_from_spectrogram,
    mfcc_from_spectrogram_numpy,
    num_frames,
    spectrogram,
    spectrogram_numpy,
)

__all__ = [
    "FeatureConfig",
    "audio_to_mfcc",
    "audio_to_mfcc_numpy",
    "mfcc_from_spectrogram",
    "mfcc_from_spectrogram_numpy",
    "num_frames",
    "spectrogram",
    "spectrogram_numpy",
]
