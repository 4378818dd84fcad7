/* Native CLI client against the stt_tpu_torch C API (the reference's
 * native_client/client.cc analogue): load a model (and optional
 * scorer), read a 16-bit PCM wav, print the transcript — in one-shot or
 * streaming mode. The model is served on the card.
 *
 * Usage: stt_client --model <artifact> --audio <wav>
 *                   [--scorer <pkg>] [--stream] [--beam_width N]
 * Requires PYTHONPATH to reach the stt_tpu_torch package.
 */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "stt_tpu.h"

static short* read_wav_pcm16(const char* path, unsigned int* n_samples) {
  FILE* f = fopen(path, "rb");
  if (!f) return NULL;
  unsigned char header[12];
  if (fread(header, 1, 12, f) != 12 || memcmp(header, "RIFF", 4) != 0 ||
      memcmp(header + 8, "WAVE", 4) != 0) {
    fclose(f);
    return NULL;
  }
  short* data = NULL;
  *n_samples = 0;
  unsigned char chunk[8];
  while (fread(chunk, 1, 8, f) == 8) {
    uint32_t size = (uint32_t)chunk[4] | ((uint32_t)chunk[5] << 8) |
                    ((uint32_t)chunk[6] << 16) | ((uint32_t)chunk[7] << 24);
    if (memcmp(chunk, "data", 4) == 0) {
      data = (short*)malloc(size);
      if (fread(data, 1, size, f) != size) {
        free(data);
        data = NULL;
      } else {
        *n_samples = size / 2;
      }
      break;
    }
    fseek(f, size + (size & 1), SEEK_CUR);
  }
  fclose(f);
  return data;
}

int main(int argc, char** argv) {
  const char* model_path = NULL;
  const char* audio_path = NULL;
  const char* scorer_path = NULL;
  int stream_mode = 0;
  unsigned int beam_width = 0;
  for (int i = 1; i < argc; ++i) {
    if (!strcmp(argv[i], "--model") && i + 1 < argc) model_path = argv[++i];
    else if (!strcmp(argv[i], "--audio") && i + 1 < argc) audio_path = argv[++i];
    else if (!strcmp(argv[i], "--scorer") && i + 1 < argc) scorer_path = argv[++i];
    else if (!strcmp(argv[i], "--beam_width") && i + 1 < argc)
      beam_width = (unsigned int)atoi(argv[++i]);
    else if (!strcmp(argv[i], "--stream")) stream_mode = 1;
    else if (!strcmp(argv[i], "--version")) {
      char* v = STT_Version();
      printf("stt_tpu_torch %s\n", v ? v : "?");
      STT_FreeString(v);
      return 0;
    }
  }
  if (!model_path || !audio_path) {
    fprintf(stderr,
            "usage: %s --model <artifact> --audio <wav> [--scorer <pkg>] "
            "[--stream] [--beam_width N]\n",
            argv[0]);
    return 2;
  }

  ModelState* model = NULL;
  int err = STT_CreateModel(model_path, &model);
  if (err != STT_ERR_OK) {
    char* message = STT_ErrorCodeToErrorMessage(err);
    fprintf(stderr, "CreateModel failed: %s\n", message);
    STT_FreeString(message);
    return 1;
  }
  if (beam_width) STT_SetModelBeamWidth(model, beam_width);
  if (scorer_path) {
    err = STT_EnableExternalScorer(model, scorer_path);
    if (err != STT_ERR_OK) {
      fprintf(stderr, "EnableExternalScorer failed (%d)\n", err);
      return 1;
    }
  }

  unsigned int n_samples = 0;
  short* pcm = read_wav_pcm16(audio_path, &n_samples);
  if (!pcm) {
    fprintf(stderr, "could not read wav %s\n", audio_path);
    return 1;
  }

  char* text = NULL;
  if (stream_mode) {
    StreamingState* stream = NULL;
    if (STT_CreateStream(model, &stream) != STT_ERR_OK) return 1;
    unsigned int chunk = (unsigned int)STT_GetModelSampleRate(model) / 2;
    for (unsigned int off = 0; off < n_samples; off += chunk) {
      unsigned int n = off + chunk <= n_samples ? chunk : n_samples - off;
      STT_FeedAudioContent(stream, pcm + off, n);
      char* partial = STT_IntermediateDecode(stream);
      if (partial && *partial) fprintf(stderr, "partial: %s\n", partial);
      STT_FreeString(partial);
    }
    text = STT_FinishStream(stream);
  } else {
    text = STT_SpeechToText(model, pcm, n_samples);
  }
  if (!text) {
    fprintf(stderr, "decode failed\n");
    return 1;
  }
  printf("%s\n", text);
  STT_FreeString(text);
  free(pcm);
  STT_FreeModel(model);
  return 0;
}
