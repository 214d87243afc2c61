from .endpoint import EnergyEndpointer
from .mel import MelConfig, log_mel_spectrogram, mel_filterbank, pcm16_to_float

__all__ = ["EnergyEndpointer", "MelConfig", "log_mel_spectrogram", "mel_filterbank",
           "pcm16_to_float"]
