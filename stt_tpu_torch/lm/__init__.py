from stt_tpu_torch.lm.kenlm import KenLMModel
from stt_tpu_torch.lm.murmur import murmur_hash64a

__all__ = ["KenLMModel", "murmur_hash64a"]
