from stt_tpu_torch.data.audio import read_audio, read_wav, write_wav

__all__ = ["read_audio", "read_wav", "write_wav"]
