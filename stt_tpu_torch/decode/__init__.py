from stt_tpu_torch.decode.beam import (
    DecodeResult,
    DecoderState,
    Wav2vec2DecoderState,
    ctc_beam_search_decoder,
    ctc_beam_search_decoder_batch,
    ctc_beam_search_decoder_for_wav2vec2am,
    make_decoder_state,
)
from stt_tpu_torch.decode.scorer import ScorerBase
from stt_tpu_torch.decode.trie import DictionaryTrie

__all__ = [
    "DecodeResult",
    "DecoderState",
    "DictionaryTrie",
    "ScorerBase",
    "Wav2vec2DecoderState",
    "ctc_beam_search_decoder",
    "ctc_beam_search_decoder_batch",
    "ctc_beam_search_decoder_for_wav2vec2am",
    "make_decoder_state",
]
