"""Streaming inference runtime: chunked audio -> incremental transcripts.

The behaviour of `stt_tpu.stream.streaming` (the reference's three-buffer
StreamingState, stt.cc:32-59,105-334):

  audio buffer  -- residual samples until the next 16 MFCC frames exist
                   ((16-1)*step + window samples)
  mfcc buffer   -- frames on the device awaiting their +/-n_context window
  model state   -- LSTM (c, h) carried across chunks on the device; per
                   chunk the audio goes in and the [16, C] probs (or the
                   pruned emissions) come out

- a frame is inferred only once its full right context exists (output
  lags input by n_context frames);
- finish drops a trailing partial audio window and pads n_context
  zero-MFCC frames (stt.cc:242-247);
- int16 audio scales by 1/32768 (stt.cc:113);
- length masking freezes (c, h) past the last real frame of a padded
  flush chunk.

Every chunk takes one path: MFCC of the new audio, context windowing, the
acoustic step (whose LSTM recurrence runs in the Hopper kernel on CUDA)
and softmax, then the decoder: the host decoder (the native C++ one unless
the scorer has no file) on the probabilities, or on the pruned emissions
through `next_pruned`, pulled to the host; or with device_decode the beam
scan on the model's device, which pulls nothing until a decode. The JAX
package's split into a fused steady-state program and a generic one only
saved TPU dispatches.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from stt_tpu_torch.alphabet import Alphabet
from stt_tpu_torch.decode.beam import make_decoder_state
from stt_tpu_torch.decode.device import DeviceStreamingDecoder, prune_emissions
from stt_tpu_torch.decode.scorer import ScorerBase
from stt_tpu_torch.frontend import FeatureConfig, audio_to_mfcc
from stt_tpu_torch.models import DeepSpeech

N_STEPS = 16  # timesteps per inference step (config.py:627-632 parity)


def auto_device_prune(n_out: int, cutoff_top_n: int, cutoff_prob: float) -> bool:
    """Should emission pruning run on the device for this decoder geometry?

    Pruning pays when the pruned (idx, logp, count, blank) tensors are
    smaller than the full [T, C] probabilities: only when the reference
    semantics truncate (cutoff_prob < 1) and the kept top-k is well under C.
    For the default 29-class alphabet with cutoff_prob=1.0 it stays off."""
    if cutoff_prob >= 1.0:
        return False
    k = min(cutoff_top_n, n_out)
    return 2 * k + 2 < n_out


class StreamingRuntime:
    """What every stream of one model shares: the model on its device and
    the configs."""

    def __init__(
        self,
        model: DeepSpeech,
        feature_config: FeatureConfig,
        alphabet: Alphabet,
        device: torch.device,
    ):
        self.model = model
        self.model_config = model.config
        self.feature_config = feature_config
        self.alphabet = alphabet
        self.device = device
        fc = feature_config
        self.chunk_samples = (N_STEPS - 1) * fc.step_samples + fc.window_samples

    def mfcc(self, audio: np.ndarray) -> torch.Tensor:
        return audio_to_mfcc(torch.from_numpy(audio).to(self.device), self.feature_config)

    @torch.no_grad()
    def window_infer(self, stacked: torch.Tensor, valid: int, c: torch.Tensor, h: torch.Tensor):
        """stacked [n_context + N_STEPS + n_context, n_input] frames ->
        (probs [N_STEPS, C], c', h'); rows past `valid` are padding."""
        mc = self.model_config
        # [N_STEPS, n_input, width] -> (tap, channel) windows
        windowed = stacked.unfold(0, mc.window_width, 1).transpose(1, 2)
        windowed = windowed.reshape(N_STEPS, mc.window_input)
        seq = torch.tensor([valid], dtype=torch.int32, device=self.device)
        logits, (c2, h2) = self.model(
            windowed[None], seq_len=seq, previous_state=(c[None], h[None]),
            overlap=False,
        )
        return torch.softmax(logits[0], dim=-1), c2[0], h2[0]

    def zero_state(self):
        n = self.model_config.n_cell_dim
        zeros = torch.zeros((n,), dtype=torch.float32, device=self.device)
        return zeros, zeros.clone()


class StreamState:
    """One live stream: host audio buffer, device frames and LSTM state,
    and a decoder (the host's, or with device_decode the device's)."""

    def __init__(
        self,
        runtime: StreamingRuntime,
        beam_width: int = 500,
        cutoff_prob: float = 1.0,
        cutoff_top_n: int = 40,
        scorer: Optional[ScorerBase] = None,
        hot_words: Optional[Dict[str, float]] = None,
        device_prune: Optional[bool] = None,
        device_decode: Optional[bool] = None,
    ):
        self.runtime = runtime
        mc = runtime.model_config
        # device_decode: the whole per-frame beam expansion and prune runs
        # on the model's device (no-LM only, so a scorer turns it off);
        # nothing decode-related crosses to the host while feeding, and the
        # backpointers are pulled at decode(). Opt-in.
        self.device_decode = bool(device_decode) and scorer is None
        # None = auto: prune on the device when it shrinks the transfer;
        # pruning disables probs_history (full-width probabilities never
        # reach the host)
        if device_prune is None:
            device_prune = auto_device_prune(mc.n_out, cutoff_top_n, cutoff_prob)
        self.device_prune = bool(device_prune) and not self.device_decode
        self._cutoff_top_n = cutoff_top_n
        self._cutoff_prob = cutoff_prob
        self._audio: np.ndarray = np.zeros((0,), np.float32)
        dev = runtime.device
        self._pending = torch.zeros((0, mc.n_input), dtype=torch.float32, device=dev)
        self._left_ctx = torch.zeros((mc.n_context, mc.n_input), dtype=torch.float32, device=dev)
        self._c, self._h = runtime.zero_state()
        self._probs_history: List[np.ndarray] = []
        if self.device_decode:
            self.decoder = DeviceStreamingDecoder(
                runtime.alphabet, beam_width, cutoff_prob, cutoff_top_n, device=dev
            )
        else:
            self.decoder = make_decoder_state(
                runtime.alphabet, beam_width, cutoff_prob, cutoff_top_n,
                scorer, hot_words,
            )
        self._finished = False

    # -- feeding -----------------------------------------------------------

    def feed_audio_content(self, audio) -> None:
        """Accept int16 PCM (scaled by 1/32768) or float32 in [-1, 1]."""
        if self._finished:
            raise RuntimeError("stream already finished")
        audio = np.asarray(audio)
        if audio.dtype == np.int16:
            audio = audio.astype(np.float32) / 32768.0
        else:
            audio = audio.astype(np.float32)
        self._audio = np.concatenate([self._audio, audio])
        self._process_audio()
        self._process_frames()

    def _process_audio(self) -> None:
        rt = self.runtime
        step = N_STEPS * rt.feature_config.step_samples
        while len(self._audio) >= rt.chunk_samples:
            frames = rt.mfcc(self._audio[: rt.chunk_samples])
            self._pending = torch.cat([self._pending, frames])
            self._audio = self._audio[step:]

    def _process_frames(self) -> None:
        n_ctx = self.runtime.model_config.n_context
        while self._pending.shape[0] >= N_STEPS + n_ctx:
            self._emit_chunk(N_STEPS)

    def _emit_chunk(self, valid: int) -> None:
        """Run one inference step over the first `valid` pending frames
        (zero-padded to N_STEPS), feed the decoder, consume the frames."""
        rt = self.runtime
        mc = rt.model_config
        n_ctx = mc.n_context
        block = self._pending[: N_STEPS + n_ctx]
        pad = N_STEPS + n_ctx - block.shape[0]
        if pad > 0:
            block = torch.cat([block, block.new_zeros((pad, mc.n_input))])
        stacked = torch.cat([self._left_ctx, block])
        probs, self._c, self._h = rt.window_infer(stacked, valid, self._c, self._h)
        if self.device_decode:
            # the padded chunk keeps its shape; frames past `valid` are no-ops
            self.decoder.next(probs, n_valid=valid)
        elif self.device_prune:
            pruned = prune_emissions(
                probs[:valid], cutoff_top_n=self._cutoff_top_n,
                cutoff_prob=self._cutoff_prob,
            )
            self.decoder.next_pruned(*(a.cpu().numpy() for a in pruned))
        else:
            host = probs[:valid].cpu().numpy()
            self._probs_history.append(host)
            self.decoder.next(host)
        # left context for the next chunk = last n_ctx frames before it
        self._left_ctx = stacked[valid : valid + n_ctx]
        self._pending = self._pending[valid:]

    # -- decoding ----------------------------------------------------------

    def intermediate_decode(self, num_results: int = 1):
        return self.decoder.decode(num_results)

    def intermediate_decode_flush_buffers(self, num_results: int = 1):
        """Decode after flushing buffered audio through the model; the
        stream cannot be fed afterwards (STT_IntermediateDecodeWithBufferFlush)."""
        self._flush()
        return self.decoder.decode(num_results)

    def finish(self, num_results: int = 1):
        self._flush()
        self._finished = True
        return self.decoder.decode(num_results)

    def _flush(self) -> None:
        if self._finished:
            return
        mc = self.runtime.model_config
        fc = self.runtime.feature_config
        # the trailing partial audio window is dropped
        n_full = max(0, (len(self._audio) - fc.window_samples) // fc.step_samples + 1)
        if n_full > 0:
            take = (n_full - 1) * fc.step_samples + fc.window_samples
            frames = self.runtime.mfcc(self._audio[:take])
            self._pending = torch.cat([self._pending, frames])
            self._audio = np.zeros((0,), np.float32)
        # zero-MFCC padding for the right context (stt.cc:242-247); the pad
        # frames are window context only, never emitted centers
        real = int(self._pending.shape[0])
        self._pending = torch.cat(
            [self._pending, self._pending.new_zeros((mc.n_context, mc.n_input))]
        )
        while real > 0:
            valid = min(N_STEPS, real)
            self._emit_chunk(valid)
            real -= valid
        self._pending = self._pending[:0]

    @property
    def probs_history(self) -> np.ndarray:
        """All emitted softmax probabilities (emissions API surface)."""
        if not self._probs_history:
            return np.zeros((0, self.runtime.model_config.n_out), np.float32)
        return np.concatenate(self._probs_history)
