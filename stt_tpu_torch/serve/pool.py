"""StreamPool: many concurrent streams, one batched acoustic step a round
(the counterpart of `stt_tpu.serve.pool`, with its interface).

The reference's streaming engine runs one stream per model invocation
(modelstate.h:16, BATCH_SIZE = 1). The pool packs every live stream's
16-frame chunk into one round on the model's device:

  mfcc:  [S, chunk_samples] -> [S, 16, n_mfcc]      (S = pool slots)
  infer: ([S, 16, window_input], seq_len [S], c [S, H], h [S, H])
         -> probs [S, 16, C] and the new state

so the LSTM recurrence runs once a round at B = S (K1 on the card), not
once a stream. Slots without a ready chunk tick with seq_len 0: the
recurrence freezes their state and emits nothing. The frame carries
(the left context and the pending 16 frames of each primed slot) stay on
the device between rounds.

Decoders are per slot: the host's (the native C++ decoder unless the
scorer has no file) get the round's probabilities, or its pruned emissions,
one round late, copied without blocking into pinned memory behind a CUDA
event that `_drain` waits on; with device_decode each slot's
`DeviceStreamingDecoder` consumes its row of the round's probabilities
where they lie, through the beam kernel (K5), and nothing crosses to the
host until a decode.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from stt_tpu_torch import trace
from stt_tpu_torch.decode.beam import make_decoder_state
from stt_tpu_torch.decode.device import DeviceStreamingDecoder, prune_emissions
from stt_tpu_torch.frontend import audio_to_mfcc
from stt_tpu_torch.stream.streaming import N_STEPS, auto_device_prune


class PooledStream:
    """The handle of one slot, with the method set of `serve.Stream`."""

    def __init__(self, pool: "StreamPool", slot: int):
        self._pool = pool
        self._slot = slot

    def feed_audio_content(self, audio) -> None:
        self._pool._feed(self._slot, audio)

    def intermediate_decode(self) -> str:
        self._pool._tick(force=False)
        self._pool._drain()
        return self._pool._decoders[self._slot].decode(1)[0].transcript

    def finish_stream(self) -> str:
        return self._pool._finish(self._slot).transcript

    def finish_stream_with_metadata(self, num_results: int = 1):
        self._pool._flush_slot(self._slot)
        results = self._pool._decoders[self._slot].decode(num_results)
        self._pool._release(self._slot)
        return self._pool._model._to_metadata(results)


class StreamPool:
    def __init__(self, model, max_streams: int = 8,
                 device_prune: Optional[bool] = None,
                 device_decode: Optional[bool] = None):
        self._model = model
        self.max_streams = max_streams
        runtime = model._runtime
        self._runtime = runtime
        mc = runtime.model_config
        # device_decode: per-slot beam decoders on the model's device
        # (no-LM only, so a scorer turns it off). Opt-in.
        self.device_decode = bool(device_decode) and model.scorer is None
        if device_prune is None:
            device_prune = auto_device_prune(mc.n_out, model._cutoff_top_n, model._cutoff_prob)
        self.device_prune = bool(device_prune) and not self.device_decode
        self._chunk_samples = runtime.chunk_samples
        dev = runtime.device
        S, n = max_streams, mc.n_cell_dim
        self._c = torch.zeros((S, n), dtype=torch.float32, device=dev)
        self._h = torch.zeros((S, n), dtype=torch.float32, device=dev)
        self._audio: List[np.ndarray] = [np.zeros((0,), np.float32) for _ in range(S)]
        # the flush's frames: the pending frames and the left context of a
        # slot being finished, on the device
        self._pending: List[torch.Tensor] = [self._no_frames() for _ in range(S)]
        self._left_ctx: List[torch.Tensor] = [self._zero_ctx() for _ in range(S)]
        self._decoders: List = [None] * S
        self._live = [False] * S
        # the frame carries of the primed slots, on the device between rounds
        self._left_dev = torch.zeros((S, mc.n_context, mc.n_input), dtype=torch.float32,
                                     device=dev)
        self._pend_dev = torch.zeros((S, N_STEPS, mc.n_input), dtype=torch.float32, device=dev)
        self._primed = np.zeros((S,), bool)
        self._inflight = None  # (host copies, their event, {slot: valid})

    def _no_frames(self) -> torch.Tensor:
        mc = self._runtime.model_config
        return torch.zeros((0, mc.n_input), dtype=torch.float32, device=self._runtime.device)

    def _zero_ctx(self) -> torch.Tensor:
        mc = self._runtime.model_config
        return torch.zeros((mc.n_context, mc.n_input), dtype=torch.float32,
                           device=self._runtime.device)

    # -- slot management ---------------------------------------------------

    def create_stream(self) -> PooledStream:
        model = self._model
        for slot in range(self.max_streams):
            if self._live[slot]:
                continue
            self._live[slot] = True
            self._audio[slot] = np.zeros((0,), np.float32)
            self._pending[slot] = self._no_frames()
            self._left_ctx[slot] = self._zero_ctx()
            for state in (self._c, self._h, self._left_dev, self._pend_dev):
                state[slot] = 0.0
            self._primed[slot] = False
            if self.device_decode:
                self._decoders[slot] = DeviceStreamingDecoder(
                    self._runtime.alphabet, model._beam_width, cutoff_prob=model._cutoff_prob,
                    cutoff_top_n=model._cutoff_top_n, device=self._runtime.device)
            else:
                self._decoders[slot] = make_decoder_state(
                    self._runtime.alphabet, model._beam_width, model._cutoff_prob,
                    model._cutoff_top_n, model.scorer, model.hot_words or None)
            return PooledStream(self, slot)
        raise RuntimeError(f"stream pool exhausted ({self.max_streams} slots)")

    def _release(self, slot: int) -> None:
        self._live[slot] = False
        self._decoders[slot] = None
        self._primed[slot] = False
        self._pending[slot] = self._no_frames()

    # -- feeding and rounds ------------------------------------------------

    def _feed(self, slot: int, audio) -> None:
        audio = np.asarray(audio)
        if audio.dtype == np.int16:
            audio = audio.astype(np.float32) / 32768.0
        self._audio[slot] = np.concatenate([self._audio[slot], audio.astype(np.float32)])
        self._tick(force=False)

    def _mfcc_ready(self, slot: int) -> bool:
        return len(self._audio[slot]) >= self._chunk_samples

    @torch.no_grad()
    def fused_round(self, chunks: torch.Tensor, mode: torch.Tensor):
        """One round over every slot: chunks [S, chunk_samples] and mode [S]
        (0 idle, 1 prime: the first chunk fills the frame carry and nothing
        emits, 2 emit) on the model's device. MFCC, context stacking,
        windowing and the acoustic step at B = S, with seq_len 16 for the
        emitting slots and 0 for the others; the carries and the LSTM state
        are updated in place. Returns the round's probabilities [S, 16, C],
        or with device_prune its pruned emissions."""
        rt = self._runtime
        mc = rt.model_config
        n_ctx = mc.n_context
        new16 = audio_to_mfcc(chunks, rt.feature_config)  # [S, 16, n_input]
        stacked = torch.cat([self._left_dev, self._pend_dev, new16[:, :n_ctx]], dim=1)
        # [S, 16, n_input, width] -> (tap, channel) windows
        windowed = stacked.unfold(1, mc.window_width, 1).transpose(2, 3)
        windowed = windowed.reshape(self.max_streams, N_STEPS, mc.window_input)
        emit = mode == 2
        seq_len = torch.where(emit, N_STEPS, 0).to(torch.int32)
        logits, (self._c, self._h) = rt.model(
            windowed, seq_len=seq_len, previous_state=(self._c, self._h), overlap=False)
        probs = torch.softmax(logits, dim=-1)
        self._left_dev = torch.where(emit[:, None, None], stacked[:, N_STEPS:N_STEPS + n_ctx],
                                     self._left_dev)
        self._pend_dev = torch.where((mode >= 1)[:, None, None], new16, self._pend_dev)
        if self.device_prune:
            return prune_emissions(probs, cutoff_top_n=self._model._cutoff_top_n,
                                   cutoff_prob=self._model._cutoff_prob)
        return probs

    def _tick(self, force: bool) -> None:
        """Advance the pool in rounds. A round fires when every live slot
        has a chunk ready (one round per 320 ms across the pool when streams
        are fed in step) or as soon as some slot is two or more chunks deep
        (a laggard must not stall the pool); with `force`, whenever a slot
        is ready."""
        fc = self._runtime.feature_config
        step = N_STEPS * fc.step_samples
        dev = self._runtime.device
        while True:
            live = [s for s in range(self.max_streams) if self._live[s]]
            ready = [s for s in live if self._mfcc_ready(s)]
            if not ready:
                break
            if not force:
                all_ready = len(ready) == len(live)
                deep = any(len(self._audio[s]) >= self._chunk_samples + step for s in ready)
                if not (all_ready or deep):
                    break
            with trace.span("pool.round"):
                chunks = np.zeros((self.max_streams, self._chunk_samples), np.float32)
                mode = np.zeros((self.max_streams,), np.int64)
                for s in ready:
                    chunks[s] = self._audio[s][: self._chunk_samples]
                    self._audio[s] = self._audio[s][step:]
                    mode[s] = 2 if self._primed[s] else 1
                out = self.fused_round(torch.from_numpy(chunks).to(dev),
                                       torch.from_numpy(mode).to(dev))
                emits = {s: N_STEPS for s in ready if self._primed[s]}
                for s in ready:
                    self._primed[s] = True
                trace.count("pool.slots", self.max_streams)
                trace.count("pool.slots_emitting", len(emits))
                if emits:
                    with trace.span("pool.beam"):
                        self._dispatch_out(out, emits)

    def _dispatch_out(self, out, valid_by_slot: Dict[int, int]) -> None:
        """Send one round's output toward the decoders: device beams consume
        their rows in place; host decoders get the round one round late, its
        copy into pinned memory queued without blocking behind the next
        round's work."""
        if self.device_decode:
            for s, valid in valid_by_slot.items():
                self._decoders[s].next(out[s], n_valid=valid)
            return
        parts = out if isinstance(out, tuple) else (out,)
        done = None
        if parts[0].is_cuda:
            host = []
            for part in parts:
                buf = torch.empty(part.shape, dtype=part.dtype, pin_memory=True)
                buf.copy_(part, non_blocking=True)
                host.append(buf)
            done = torch.cuda.Event()
            done.record()
            parts = tuple(host)
        self._drain()
        self._inflight = (parts, done, dict(valid_by_slot))

    def _drain(self) -> None:
        """Feed the host decoders the round in flight, once its copy has
        completed (its event), and nothing before."""
        if self._inflight is None:
            return
        parts, done, valid_by_slot = self._inflight
        self._inflight = None
        if done is not None:
            done.synchronize()
        arrays = [p.numpy() for p in parts]
        for s, valid in valid_by_slot.items():
            if not self._live[s]:
                continue
            if self.device_prune:
                self._decoders[s].next_pruned(*(a[s, :valid] for a in arrays))
            else:
                self._decoders[s].next(arrays[0][s, :valid])

    @torch.no_grad()
    def _run_infer(self, valid_by_slot: Dict[int, int]) -> None:
        """The flush's step: each given slot's next `valid` pending frames
        (zero-padded to 16) with its left context, at B = S, the other slots
        at seq_len 0; the decoders get their rows at once."""
        rt = self._runtime
        mc = rt.model_config
        n_ctx = mc.n_context
        S, dev = self.max_streams, rt.device
        windowed = torch.zeros((S, N_STEPS, mc.window_input), dtype=torch.float32, device=dev)
        seq_len = np.zeros((S,), np.int32)
        for s, valid in valid_by_slot.items():
            block = self._pending[s][: N_STEPS + n_ctx]
            pad = N_STEPS + n_ctx - block.shape[0]
            if pad > 0:
                block = torch.cat([block, block.new_zeros((pad, mc.n_input))])
            stacked = torch.cat([self._left_ctx[s], block])
            windowed[s] = stacked.unfold(0, mc.window_width, 1).transpose(1, 2).reshape(
                N_STEPS, mc.window_input)
            seq_len[s] = valid
            self._left_ctx[s] = stacked[valid:valid + n_ctx]
            self._pending[s] = self._pending[s][valid:]
        logits, (self._c, self._h) = rt.model(
            windowed, seq_len=torch.from_numpy(seq_len).to(dev),
            previous_state=(self._c, self._h), overlap=False)
        probs = torch.softmax(logits, dim=-1)
        for s, valid in valid_by_slot.items():
            if self.device_decode:
                self._decoders[s].next(probs[s], n_valid=valid)
            elif self.device_prune:
                pruned = prune_emissions(probs[s, :valid], cutoff_top_n=self._model._cutoff_top_n,
                                         cutoff_prob=self._model._cutoff_prob)
                self._decoders[s].next_pruned(*(a.cpu().numpy() for a in pruned))
            else:
                self._decoders[s].next(probs[s, :valid].cpu().numpy())

    # -- finishing ---------------------------------------------------------

    def _flush_slot(self, slot: int) -> None:
        fc = self._runtime.feature_config
        mc = self._runtime.model_config
        # buffered full chunks go through the rounds; then the slot's frame
        # carry is handed to the flush
        self._tick(force=True)
        self._drain()
        if self._primed[slot]:
            self._left_ctx[slot] = self._left_dev[slot].clone()
            self._pending[slot] = self._pend_dev[slot].clone()
        # the leftover full windows; a trailing partial window is dropped
        n_full = max(0, (len(self._audio[slot]) - fc.window_samples) // fc.step_samples + 1)
        if n_full > 0:
            take = (n_full - 1) * fc.step_samples + fc.window_samples
            frames = self._runtime.mfcc(self._audio[slot][:take])
            self._pending[slot] = torch.cat([self._pending[slot], frames])
        self._audio[slot] = np.zeros((0,), np.float32)
        real = int(self._pending[slot].shape[0])
        # zero-MFCC frames for the right context (stt.cc:242-247)
        self._pending[slot] = torch.cat(
            [self._pending[slot], self._pending[slot].new_zeros((mc.n_context, mc.n_input))])
        while real > 0:
            valid = min(N_STEPS, real)
            self._run_infer({slot: valid})
            real -= valid
        self._pending[slot] = self._no_frames()

    def _finish(self, slot: int):
        self._flush_slot(slot)
        result = self._decoders[slot].decode(1)[0]
        self._release(slot)
        return result
