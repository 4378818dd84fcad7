"""stt_tpu_torch - the PyTorch/CUDA port of stt_tpu.

The serving and training paths of `stt_tpu` in PyTorch, for an NVIDIA
H100: artifact loading, the MFCC frontend, the DeepSpeech acoustic model
whose LSTM recurrence runs in CUDA kernels written for Hopper (inference,
and training forward and backward), CTC beam decoding (the native C++
decoder on the host, with KenLM .scorer packages and hot words; or the
beam kernel on the card) and greedy decoding, the CTC loss, streaming,
the `Model`/`Stream` API, the trainer, and evaluation, export and
transcription of long recordings. It imports
nothing of `stt_tpu` and no JAX; the two packages share the artifact
format, so one exported model loads in both.

Package layout:
  stt_tpu_torch.alphabet   - token<->index maps (copy of stt_tpu.alphabet)
  stt_tpu_torch.config     - SttConfig, the training flags
  stt_tpu_torch.device     - device selection (CUDA unless asked otherwise)
  stt_tpu_torch.frontend   - framing + spectrogram + MFCC
  stt_tpu_torch.models     - DeepSpeech nn.Module, plain LSTM recurrence
  stt_tpu_torch.ops        - CUDA kernels (csrc/) and their wrappers
  stt_tpu_torch.artifact   - weights.npz + metadata.json + alphabet.txt
  stt_tpu_torch.ctc        - greedy decode, CTC loss
  stt_tpu_torch.data       - WAV IO, CSV sources, padded batches, VAD
  stt_tpu_torch.decode     - CTC prefix beam search (native and Python),
                             .scorer packages, vocabulary tries, emission
                             pruning, the beam search on the card
  stt_tpu_torch.lm         - KenLM binary reader and writer, ARPA models
  stt_tpu_torch.native     - the native decoder's C++ source, its two
                             harnesses (decoder_smoke.cc, prof_decoder.cc),
                             and the C API's (stt_tpu.h, stt_c_api.cpp,
                             stt_client.c)
  stt_tpu_torch.tools      - generate_scorer_package, generate_lm and the
                             other LM and data tools, downloader, the 26
                             corpus importers (import_*.py, importers,
                             ldc_conversational)
  stt_tpu_torch.stream     - stateful streaming inference
  stt_tpu_torch.serve      - user-facing Model/Stream API, the stream pool,
                             and the C API's bridge (cbridge) and build (capi)
  stt_tpu_torch.compat     - reference .tflite and TF checkpoint interop
  stt_tpu_torch.io         - remote paths (gs://, hdfs://, mem://)
  stt_tpu_torch.train      - train/eval steps, checkpoints, the trainer
  stt_tpu_torch.client     - `stt`-style command line client
  stt_tpu_torch.evaluate   - test-set WER/CER of a checkpoint (with
                             evaluate_tools, text, evaluate_from_csv)
  stt_tpu_torch.export     - checkpoint -> artifact, .sttpkg, model card
  stt_tpu_torch.transcribe - VAD-segmented transcription to .tlog files
  stt_tpu_torch.evaluate_export - WER/CER of an exported artifact
"""

__version__ = "0.1.0"

GRAPH_VERSION = 6  # artifact-format generation, the same as stt_tpu's
