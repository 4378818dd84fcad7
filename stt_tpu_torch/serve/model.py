"""User-facing inference API: Model / Stream, with the method set of
`stt_tpu.serve.model` (the reference's C API, coqui-stt.h):

  STT_CreateModel            -> Model(path)
  STT_EnableExternalScorer   -> model.enable_external_scorer(path)
  STT_DisableExternalScorer  -> model.disable_external_scorer()
  STT_SetScorerAlphaBeta     -> model.set_scorer_alpha_beta(a, b)
  STT_AddHotWord/Erase/Clear -> model.add_hot_word / erase_hot_word / ...
  STT_SpeechToText           -> model.stt(audio)
  STT_SpeechToTextWithMetadata -> model.stt_with_metadata(audio, n)
  STT_CreateStream           -> model.create_stream()
  STT_FeedAudioContent       -> stream.feed_audio_content(audio)
  STT_IntermediateDecode     -> stream.intermediate_decode()
  STT_FinishStream           -> stream.finish_stream()
  STT_FinishStreamWithMetadata -> stream.finish_stream_with_metadata(n)

The model runs on the card (device="cuda") unless the caller passes
device="cpu", always under torch.no_grad(), so its LSTM takes the inference
kernel (K1) and never the training kernels. With quantized_inference=True
`infer_logits` takes the int8 path (`stt_tpu_torch.ops.quant`, whose
recurrence is the int8 kernel K2); `create_stream(device_decode=True)`
decodes on the model's device (`stt_tpu_torch.decode.device`, the beam
kernel K5). Every other stream decodes on the host in the native C++
decoder (`stt_tpu_torch.decode.native`), with the external scorer (a
.scorer package: KenLM model and vocabulary) and hot words when they are
set; a scorer loaded from a buffer has no file for the C++ decoder to read
and takes the Python decoder.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from stt_tpu_torch.artifact import (
    feature_config_from_metadata,
    load_artifact,
    model_config_from_metadata,
    params_from_numpy,
)
from stt_tpu_torch.decode.beam import DecodeResult
from stt_tpu_torch.decode.scorer import ScorerBase
from stt_tpu_torch.device import resolve_device
from stt_tpu_torch.stream.streaming import StreamingRuntime, StreamState


@dataclasses.dataclass
class TokenMetadata:
    text: str
    timestep: int
    start_time: float


@dataclasses.dataclass
class CandidateTranscript:
    tokens: List[TokenMetadata]
    confidence: float

    @property
    def transcript(self) -> str:
        return "".join(t.text for t in self.tokens)


@dataclasses.dataclass
class Metadata:
    transcripts: List[CandidateTranscript]


class Model:
    def __init__(
        self, model_path: str, quantized_inference: bool = False, device="cuda"
    ):
        """quantized_inference=True runs batch forwards (`infer_logits`)
        through the int8 path; streams stay float (batch 1, 16 frames)."""
        self.device = resolve_device(device)
        params, metadata, alphabet = load_artifact(model_path)
        self.metadata = metadata
        self.alphabet = alphabet
        self.model_config = model_config_from_metadata(metadata)
        self.feature_config = feature_config_from_metadata(metadata)
        model = params_from_numpy(params, self.model_config, device=self.device)
        self._runtime = StreamingRuntime(
            model, self.feature_config, alphabet, self.device
        )
        self._qparams = None
        if quantized_inference:
            from stt_tpu_torch.ops.quant import quantize_params

            self._qparams = quantize_params(
                dict(model.named_parameters()), self.model_config
            )
        self._beam_width = int(metadata.get("beam_width", 500))
        self._cutoff_prob = 1.0
        self._cutoff_top_n = 40
        self.scorer: Optional[ScorerBase] = None
        self.hot_words: Dict[str, float] = {}

    # -- config surface ----------------------------------------------------

    def sample_rate(self) -> int:
        return self.feature_config.sample_rate

    @property
    def beam_width(self) -> int:
        return self._beam_width

    def set_model_beam_width(self, width: int) -> None:
        self._beam_width = int(width)

    def enable_external_scorer(self, scorer_path: str) -> None:
        """Decode with the .scorer package at `scorer_path`, at the alpha
        and beta stored in it."""
        from stt_tpu_torch.decode.scorer_package import KenLMScorer

        self.scorer = KenLMScorer(scorer_path)

    def enable_external_scorer_from_buffer(self, data: bytes) -> None:
        from stt_tpu_torch.decode.scorer_package import KenLMScorer

        self.scorer = KenLMScorer(data=data)

    def disable_external_scorer(self) -> None:
        self.scorer = None

    def set_scorer_alpha_beta(self, alpha: float, beta: float) -> None:
        if self.scorer is None:
            raise RuntimeError("no scorer enabled")
        self.scorer.reset_params(alpha, beta)

    def add_hot_word(self, word: str, boost: float) -> None:
        self.hot_words[word] = float(boost)

    def erase_hot_word(self, word: str) -> None:
        self.hot_words.pop(word, None)

    def clear_hot_words(self) -> None:
        self.hot_words.clear()

    # -- recognition -------------------------------------------------------

    def create_stream(
        self,
        device_prune: Optional[bool] = None,
        device_decode: Optional[bool] = None,
    ) -> "Stream":
        return Stream(self, device_prune=device_prune, device_decode=device_decode)

    def stt(self, audio) -> str:
        stream = self.create_stream()
        stream.feed_audio_content(audio)
        return stream.finish_stream()

    def stt_with_metadata(self, audio, num_results: int = 1) -> Metadata:
        stream = self.create_stream()
        stream.feed_audio_content(audio)
        return stream.finish_stream_with_metadata(num_results)

    def stt_with_emissions(self, audio) -> Tuple[str, np.ndarray]:
        """Transcript plus the per-frame softmax emissions
        (STT_SpeechToTextWithEmissions); emission pruning is off for this
        stream, so the full-width probabilities reach the host."""
        stream = self.create_stream(device_prune=False, device_decode=False)
        stream.feed_audio_content(audio)
        text = stream.finish_stream()
        return text, stream._state.probs_history

    @torch.no_grad()
    def infer_logits(self, features, lengths) -> torch.Tensor:
        """Batched acoustic forward [B, T, n_mfcc] -> [B, T, n_out] f32
        logits on the model's device; through the int8 path when the model
        was opened with quantized_inference=True. Features and lengths may
        be host arrays or tensors (on any device)."""
        seq = torch.as_tensor(lengths, dtype=torch.int32).to(self.device)
        feats = torch.as_tensor(features, dtype=torch.float32).to(self.device)
        if self._qparams is not None:
            from stt_tpu_torch.ops.quant import apply_model_quantized

            logits, _ = apply_model_quantized(
                self._qparams, feats, seq_len=seq, config=self.model_config
            )
        else:
            logits, _ = self._runtime.model(feats, seq_len=seq)
        return logits

    def _to_metadata(self, results: List[DecodeResult]) -> Metadata:
        step_s = self.feature_config.step_samples / self.feature_config.sample_rate
        transcripts = []
        for res in results:
            tokens = [
                TokenMetadata(
                    text=self.alphabet.decode_single(tok),
                    timestep=ts,
                    start_time=ts * step_s,
                )
                for tok, ts in zip(res.tokens, res.timesteps)
            ]
            transcripts.append(
                CandidateTranscript(tokens=tokens, confidence=res.confidence)
            )
        return Metadata(transcripts=transcripts)


class Stream:
    def __init__(self, model: Model, device_prune: Optional[bool] = None,
                 device_decode: Optional[bool] = None):
        self.model = model
        self._state = StreamState(
            model._runtime,
            beam_width=model._beam_width,
            cutoff_prob=model._cutoff_prob,
            cutoff_top_n=model._cutoff_top_n,
            scorer=model.scorer,
            hot_words=model.hot_words or None,
            device_prune=device_prune,
            device_decode=device_decode,
        )

    def feed_audio_content(self, audio) -> None:
        self._state.feed_audio_content(audio)

    def intermediate_decode(self) -> str:
        return self._state.intermediate_decode(1)[0].transcript

    def intermediate_decode_with_metadata(self, num_results: int = 1) -> Metadata:
        return self.model._to_metadata(self._state.intermediate_decode(num_results))

    def intermediate_decode_flush_buffers(self) -> str:
        return self._state.intermediate_decode_flush_buffers(1)[0].transcript

    def finish_stream(self) -> str:
        return self._state.finish(1)[0].transcript

    def finish_stream_with_metadata(self, num_results: int = 1) -> Metadata:
        return self.model._to_metadata(self._state.finish(num_results))
