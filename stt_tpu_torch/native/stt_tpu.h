/* C API for the stt_tpu_torch port (the header of stt_tpu's C API, with
 * the same ABI, so a C program links either library).
 *
 * Mirrors the reference's deployment surface (native_client/coqui-stt.h:
 * model/stream lifecycle, one-shot + streaming recognition, external
 * scorer + hot words, token metadata, error enum) while being backed by
 * the embedded stt_tpu_torch Python runtime (PyTorch, CUDA kernels on the
 * card). Link against libstt_tpu_torch.so; the hosting process gains an
 * embedded interpreter on first use (or reuses the current one when loaded
 * from Python).
 */
#ifndef STT_TPU_H
#define STT_TPU_H

#ifdef __cplusplus
extern "C" {
#endif

#define STT_EXPORT __attribute__((visibility("default")))

typedef struct ModelState ModelState;
typedef struct StreamingState StreamingState;

/* One recognized token with its timing (modelstate.cc:55 semantics:
 * start_time = timestep * window_step / sample_rate). */
typedef struct TokenMetadata {
  const char* text;
  unsigned int timestep;
  float start_time;
} TokenMetadata;

typedef struct CandidateTranscript {
  const TokenMetadata* tokens;
  unsigned int num_tokens;
  double confidence;
} CandidateTranscript;

typedef struct Metadata {
  const CandidateTranscript* transcripts;
  unsigned int num_transcripts;
} Metadata;

enum STT_Error_Codes {
  STT_ERR_OK = 0x0000,
  STT_ERR_NO_MODEL = 0x1000,
  STT_ERR_INVALID_ALPHABET = 0x2000,
  STT_ERR_INVALID_SHAPE = 0x2001,
  STT_ERR_INVALID_SCORER = 0x2002,
  STT_ERR_MODEL_INCOMPATIBLE = 0x2003,
  STT_ERR_SCORER_NOT_ENABLED = 0x2004,
  STT_ERR_SCORER_UNREADABLE = 0x2005,
  STT_ERR_SCORER_INVALID_LM = 0x2006,
  STT_ERR_SCORER_NO_TRIE = 0x2007,
  STT_ERR_SCORER_INVALID_TRIE = 0x2008,
  STT_ERR_SCORER_VERSION_MISMATCH = 0x2009,
  STT_ERR_FAIL_INIT_MMAP = 0x3000,
  STT_ERR_FAIL_INIT_SESS = 0x3001,
  STT_ERR_FAIL_INTERPRETER = 0x3002,
  STT_ERR_FAIL_RUN_SESS = 0x3003,
  STT_ERR_FAIL_CREATE_STREAM = 0x3004,
  STT_ERR_FAIL_READ_PROTOBUF = 0x3005,
  STT_ERR_FAIL_CREATE_SESS = 0x3006,
  STT_ERR_FAIL_CREATE_MODEL = 0x3007,
  STT_ERR_FAIL_INSERT_HOTWORD = 0x3008,
  STT_ERR_FAIL_CLEAR_HOTWORD = 0x3009,
  STT_ERR_FAIL_ERASE_HOTWORD = 0x3010,
};

/* -- model lifecycle ----------------------------------------------------- */

STT_EXPORT int STT_CreateModel(const char* model_path, ModelState** retval);
STT_EXPORT void STT_FreeModel(ModelState* ctx);

STT_EXPORT unsigned int STT_GetModelBeamWidth(const ModelState* ctx);
STT_EXPORT int STT_SetModelBeamWidth(ModelState* ctx, unsigned int beam_width);
STT_EXPORT int STT_GetModelSampleRate(const ModelState* ctx);

/* -- external scorer + hot words ----------------------------------------- */

STT_EXPORT int STT_EnableExternalScorer(ModelState* ctx, const char* path);
STT_EXPORT int STT_DisableExternalScorer(ModelState* ctx);
STT_EXPORT int STT_SetScorerAlphaBeta(ModelState* ctx, float alpha, float beta);
STT_EXPORT int STT_AddHotWord(ModelState* ctx, const char* word, float boost);
STT_EXPORT int STT_EraseHotWord(ModelState* ctx, const char* word);
STT_EXPORT int STT_ClearHotWords(ModelState* ctx);

/* -- one-shot recognition ------------------------------------------------- */

/* 16-bit 16 kHz mono PCM in; transcript out (free with STT_FreeString). */
STT_EXPORT char* STT_SpeechToText(ModelState* ctx, const short* buffer,
                                  unsigned int buffer_size);
STT_EXPORT Metadata* STT_SpeechToTextWithMetadata(ModelState* ctx,
                                                  const short* buffer,
                                                  unsigned int buffer_size,
                                                  unsigned int num_results);

/* -- streaming ------------------------------------------------------------ */

STT_EXPORT int STT_CreateStream(ModelState* ctx, StreamingState** retval);
STT_EXPORT void STT_FeedAudioContent(StreamingState* sctx, const short* buffer,
                                     unsigned int buffer_size);
STT_EXPORT char* STT_IntermediateDecode(StreamingState* sctx);
STT_EXPORT Metadata* STT_IntermediateDecodeWithMetadata(
    StreamingState* sctx, unsigned int num_results);
STT_EXPORT char* STT_FinishStream(StreamingState* sctx);
STT_EXPORT Metadata* STT_FinishStreamWithMetadata(StreamingState* sctx,
                                                  unsigned int num_results);
STT_EXPORT void STT_FreeStream(StreamingState* sctx);

/* -- memory / misc -------------------------------------------------------- */

STT_EXPORT void STT_FreeMetadata(Metadata* m);
STT_EXPORT void STT_FreeString(char* str);
STT_EXPORT char* STT_Version(void);
STT_EXPORT char* STT_ErrorCodeToErrorMessage(int error_code);

#undef STT_EXPORT

#ifdef __cplusplus
}
#endif

#endif /* STT_TPU_H */
