// libstt_tpu_torch: C API over the embedded stt_tpu_torch runtime.
//
// The reference's deployment library (native_client/stt.cc) fronts a
// TFLite interpreter; here the same C surface (stt_tpu.h, the ABI of
// stt_tpu's libstt_tpu) fronts the port's Python/PyTorch runtime through
// stt_tpu_torch.serve.cbridge, whose models run on the card (K1, the LSTM
// recurrence kernel, on every chunk). The library works both embedded in
// a C/C++ process (it boots an interpreter on first use, as the Python
// named by STT_PYTHON_EXECUTABLE at build time would start, so that
// Python's site-packages are found; set PYTHONPATH to reach the
// stt_tpu_torch package) and loaded from Python via ctypes (it reuses the
// running interpreter). Built by stt_tpu_torch.serve.capi.

#include "stt_tpu.h"

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdlib>
#include <cstring>
#include <string>

struct ModelState {
  long handle;
};
struct StreamingState {
  long handle;
};

namespace {

PyThreadState* g_main_state = nullptr;

class Gil {
 public:
  Gil() : state_(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(state_); }

 private:
  PyGILState_STATE state_;
};

#ifndef STT_PYTHON_EXECUTABLE
#define STT_PYTHON_EXECUTABLE ""
#endif

bool ensure_python() {
  if (Py_IsInitialized()) return true;
  PyConfig config;
  PyConfig_InitPythonConfig(&config);
  config.install_signal_handlers = 0;
  config.parse_argv = 0;
  PyStatus status = PyStatus_Ok();
  if (STT_PYTHON_EXECUTABLE[0])
    status = PyConfig_SetBytesString(&config, &config.program_name,
                                     STT_PYTHON_EXECUTABLE);
  if (!PyStatus_Exception(status)) status = Py_InitializeFromConfig(&config);
  PyConfig_Clear(&config);
  if (PyStatus_Exception(status)) {
    fprintf(stderr, "stt_tpu_torch: cannot start Python: %s\n",
            status.err_msg ? status.err_msg : "?");
    return false;
  }
  // release the GIL acquired by initialization so Gil{} works from any
  // thread, including this one
  g_main_state = PyEval_SaveThread();
  return true;
}

PyObject* bridge() {  // borrowed-ish: cached strong reference
  static PyObject* mod = nullptr;
  if (!mod) {
    mod = PyImport_ImportModule("stt_tpu_torch.serve.cbridge");
    if (!mod) PyErr_Print();
  }
  return mod;
}

// Maps the active Python exception to an STT error code and clears it.
int map_exception() {
  PyObject *type = nullptr, *value = nullptr, *trace = nullptr;
  PyErr_Fetch(&type, &value, &trace);
  int code = STT_ERR_FAIL_RUN_SESS;
  if (type) {
    PyObject* name_obj = PyObject_GetAttrString(type, "__name__");
    std::string name =
        name_obj && PyUnicode_Check(name_obj) ? PyUnicode_AsUTF8(name_obj) : "";
    Py_XDECREF(name_obj);
    std::string message;
    if (value) {
      PyObject* s = PyObject_Str(value);
      if (s) message = PyUnicode_AsUTF8(s);
      Py_XDECREF(s);
    }
    if (name == "FileNotFoundError")
      code = STT_ERR_NO_MODEL;
    else if (name == "ScorerLoadError")
      code = message.find("version") != std::string::npos
                 ? STT_ERR_SCORER_VERSION_MISMATCH
                 : STT_ERR_INVALID_SCORER;
    else if (name == "KeyError")
      code = STT_ERR_FAIL_CREATE_STREAM;
    else if (message.find("scorer") != std::string::npos)
      code = STT_ERR_SCORER_NOT_ENABLED;
    fprintf(stderr, "stt_tpu_torch: %s: %s\n", name.c_str(), message.c_str());
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(trace);
  return code;
}

// Call a cbridge function; returns a new reference or nullptr.
PyObject* call(const char* fn, const char* format, ...) {
  PyObject* mod = bridge();
  if (!mod) return nullptr;
  PyObject* callable = PyObject_GetAttrString(mod, fn);
  if (!callable) return nullptr;
  va_list args;
  va_start(args, format);
  PyObject* argtuple = Py_VaBuildValue(format, args);
  va_end(args);
  PyObject* result = nullptr;
  if (argtuple) {
    result = PyObject_CallObject(
        callable, PyTuple_Check(argtuple) ? argtuple : nullptr);
    if (!PyTuple_Check(argtuple) && !result) {
      // single-arg format: wrap
      PyErr_Clear();
      PyObject* wrapped = PyTuple_Pack(1, argtuple);
      result = PyObject_CallObject(callable, wrapped);
      Py_DECREF(wrapped);
    }
  }
  Py_XDECREF(argtuple);
  Py_DECREF(callable);
  return result;
}

char* dup_py_str(PyObject* obj) {
  if (!obj) return nullptr;
  const char* s = PyUnicode_AsUTF8(obj);
  return s ? strdup(s) : nullptr;
}

// [(confidence, [(text, timestep, start), ...]), ...] -> Metadata*
Metadata* build_metadata(PyObject* list) {
  if (!list || !PyList_Check(list)) return nullptr;
  unsigned int n = (unsigned int)PyList_Size(list);
  auto* transcripts =
      (CandidateTranscript*)calloc(n, sizeof(CandidateTranscript));
  for (unsigned int i = 0; i < n; ++i) {
    PyObject* entry = PyList_GetItem(list, i);  // borrowed
    PyObject* confidence = PyTuple_GetItem(entry, 0);
    PyObject* tokens = PyTuple_GetItem(entry, 1);
    unsigned int m = (unsigned int)PyList_Size(tokens);
    auto* toks = (TokenMetadata*)calloc(m, sizeof(TokenMetadata));
    for (unsigned int j = 0; j < m; ++j) {
      PyObject* tok = PyList_GetItem(tokens, j);
      toks[j].text = dup_py_str(PyTuple_GetItem(tok, 0));
      toks[j].timestep = (unsigned int)PyLong_AsLong(PyTuple_GetItem(tok, 1));
      toks[j].start_time = (float)PyFloat_AsDouble(PyTuple_GetItem(tok, 2));
    }
    transcripts[i].tokens = toks;
    transcripts[i].num_tokens = m;
    transcripts[i].confidence = PyFloat_AsDouble(confidence);
  }
  auto* metadata = (Metadata*)calloc(1, sizeof(Metadata));
  metadata->transcripts = transcripts;
  metadata->num_transcripts = n;
  return metadata;
}

}  // namespace

extern "C" {

int STT_CreateModel(const char* model_path, ModelState** retval) {
  if (!retval) return STT_ERR_FAIL_CREATE_MODEL;
  *retval = nullptr;
  if (!model_path) return STT_ERR_FAIL_CREATE_MODEL;
  if (!ensure_python()) return STT_ERR_FAIL_INIT_SESS;
  Gil gil;
  PyObject* result = call("create_model", "(s)", model_path);
  if (!result) return map_exception();
  long handle = PyLong_AsLong(result);
  Py_DECREF(result);
  *retval = new ModelState{handle};
  return STT_ERR_OK;
}

void STT_FreeModel(ModelState* ctx) {
  if (!ctx) return;
  Gil gil;
  Py_XDECREF(call("free_model", "(l)", ctx->handle));
  delete ctx;
}

unsigned int STT_GetModelBeamWidth(const ModelState* ctx) {
  if (!ctx) return 0;
  Gil gil;
  PyObject* result = call("get_beam_width", "(l)", ctx->handle);
  if (!result) {
    map_exception();
    return 0;
  }
  long width = PyLong_AsLong(result);
  Py_DECREF(result);
  return (unsigned int)width;
}

int STT_SetModelBeamWidth(ModelState* ctx, unsigned int beam_width) {
  if (!ctx) return STT_ERR_NO_MODEL;
  Gil gil;
  PyObject* result =
      call("set_beam_width", "(ll)", ctx->handle, (long)beam_width);
  if (!result) return map_exception();
  Py_DECREF(result);
  return STT_ERR_OK;
}

int STT_GetModelSampleRate(const ModelState* ctx) {
  if (!ctx) return -1;
  Gil gil;
  PyObject* result = call("get_sample_rate", "(l)", ctx->handle);
  if (!result) {
    map_exception();
    return -1;
  }
  long rate = PyLong_AsLong(result);
  Py_DECREF(result);
  return (int)rate;
}

int STT_EnableExternalScorer(ModelState* ctx, const char* path) {
  if (!ctx) return STT_ERR_NO_MODEL;
  Gil gil;
  PyObject* result =
      call("enable_external_scorer", "(ls)", ctx->handle, path);
  if (!result) return map_exception();
  Py_DECREF(result);
  return STT_ERR_OK;
}

int STT_DisableExternalScorer(ModelState* ctx) {
  if (!ctx) return STT_ERR_NO_MODEL;
  Gil gil;
  PyObject* result = call("disable_external_scorer", "(l)", ctx->handle);
  if (!result) return map_exception();
  Py_DECREF(result);
  return STT_ERR_OK;
}

int STT_SetScorerAlphaBeta(ModelState* ctx, float alpha, float beta) {
  if (!ctx) return STT_ERR_NO_MODEL;
  Gil gil;
  PyObject* result = call("set_scorer_alpha_beta", "(ldd)", ctx->handle,
                          (double)alpha, (double)beta);
  if (!result) return map_exception();
  Py_DECREF(result);
  return STT_ERR_OK;
}

int STT_AddHotWord(ModelState* ctx, const char* word, float boost) {
  if (!ctx || !word) return STT_ERR_FAIL_INSERT_HOTWORD;
  Gil gil;
  PyObject* result =
      call("add_hot_word", "(lsd)", ctx->handle, word, (double)boost);
  if (!result) {
    map_exception();
    return STT_ERR_FAIL_INSERT_HOTWORD;
  }
  Py_DECREF(result);
  return STT_ERR_OK;
}

int STT_EraseHotWord(ModelState* ctx, const char* word) {
  if (!ctx || !word) return STT_ERR_FAIL_ERASE_HOTWORD;
  Gil gil;
  PyObject* result = call("erase_hot_word", "(ls)", ctx->handle, word);
  if (!result) {
    map_exception();
    return STT_ERR_FAIL_ERASE_HOTWORD;
  }
  Py_DECREF(result);
  return STT_ERR_OK;
}

int STT_ClearHotWords(ModelState* ctx) {
  if (!ctx) return STT_ERR_FAIL_CLEAR_HOTWORD;
  Gil gil;
  PyObject* result = call("clear_hot_words", "(l)", ctx->handle);
  if (!result) {
    map_exception();
    return STT_ERR_FAIL_CLEAR_HOTWORD;
  }
  Py_DECREF(result);
  return STT_ERR_OK;
}

char* STT_SpeechToText(ModelState* ctx, const short* buffer,
                       unsigned int buffer_size) {
  if (!ctx || !buffer) return nullptr;
  Gil gil;
  PyObject* result =
      call("speech_to_text", "(ly#)", ctx->handle, (const char*)buffer,
           (Py_ssize_t)(buffer_size * sizeof(short)));
  if (!result) {
    map_exception();
    return nullptr;
  }
  char* text = dup_py_str(result);
  Py_DECREF(result);
  return text;
}

Metadata* STT_SpeechToTextWithMetadata(ModelState* ctx, const short* buffer,
                                       unsigned int buffer_size,
                                       unsigned int num_results) {
  if (!ctx || !buffer) return nullptr;
  Gil gil;
  PyObject* result = call("speech_to_text_with_metadata", "(ly#l)",
                          ctx->handle, (const char*)buffer,
                          (Py_ssize_t)(buffer_size * sizeof(short)),
                          (long)num_results);
  if (!result) {
    map_exception();
    return nullptr;
  }
  Metadata* metadata = build_metadata(result);
  Py_DECREF(result);
  return metadata;
}

int STT_CreateStream(ModelState* ctx, StreamingState** retval) {
  if (!retval) return STT_ERR_FAIL_CREATE_STREAM;
  *retval = nullptr;
  if (!ctx) return STT_ERR_NO_MODEL;
  Gil gil;
  PyObject* result = call("create_stream", "(l)", ctx->handle);
  if (!result) return map_exception();
  long handle = PyLong_AsLong(result);
  Py_DECREF(result);
  *retval = new StreamingState{handle};
  return STT_ERR_OK;
}

void STT_FeedAudioContent(StreamingState* sctx, const short* buffer,
                          unsigned int buffer_size) {
  if (!sctx || !buffer) return;
  Gil gil;
  PyObject* result =
      call("feed_audio_content", "(ly#)", sctx->handle, (const char*)buffer,
           (Py_ssize_t)(buffer_size * sizeof(short)));
  if (!result)
    map_exception();
  else
    Py_DECREF(result);
}

char* STT_IntermediateDecode(StreamingState* sctx) {
  if (!sctx) return nullptr;
  Gil gil;
  PyObject* result = call("intermediate_decode", "(l)", sctx->handle);
  if (!result) {
    map_exception();
    return nullptr;
  }
  char* text = dup_py_str(result);
  Py_DECREF(result);
  return text;
}

Metadata* STT_IntermediateDecodeWithMetadata(StreamingState* sctx,
                                             unsigned int num_results) {
  if (!sctx) return nullptr;
  Gil gil;
  PyObject* result = call("intermediate_decode_with_metadata", "(ll)",
                          sctx->handle, (long)num_results);
  if (!result) {
    map_exception();
    return nullptr;
  }
  Metadata* metadata = build_metadata(result);
  Py_DECREF(result);
  return metadata;
}

char* STT_FinishStream(StreamingState* sctx) {
  if (!sctx) return nullptr;
  Gil gil;
  PyObject* result = call("finish_stream", "(l)", sctx->handle);
  char* text = nullptr;
  if (!result)
    map_exception();
  else {
    text = dup_py_str(result);
    Py_DECREF(result);
  }
  delete sctx;
  return text;
}

Metadata* STT_FinishStreamWithMetadata(StreamingState* sctx,
                                       unsigned int num_results) {
  if (!sctx) return nullptr;
  Gil gil;
  PyObject* result = call("finish_stream_with_metadata", "(ll)",
                          sctx->handle, (long)num_results);
  Metadata* metadata = nullptr;
  if (!result)
    map_exception();
  else {
    metadata = build_metadata(result);
    Py_DECREF(result);
  }
  delete sctx;
  return metadata;
}

void STT_FreeStream(StreamingState* sctx) {
  if (!sctx) return;
  Gil gil;
  Py_XDECREF(call("free_stream", "(l)", sctx->handle));
  delete sctx;
}

void STT_FreeMetadata(Metadata* m) {
  if (!m) return;
  for (unsigned int i = 0; i < m->num_transcripts; ++i) {
    for (unsigned int j = 0; j < m->transcripts[i].num_tokens; ++j)
      free((void*)m->transcripts[i].tokens[j].text);
    free((void*)m->transcripts[i].tokens);
  }
  free((void*)m->transcripts);
  free(m);
}

void STT_FreeString(char* str) { free(str); }

char* STT_Version(void) {
  if (!ensure_python()) return nullptr;
  Gil gil;
  PyObject* result = call("version", "()");
  if (!result) {
    map_exception();
    return nullptr;
  }
  char* text = dup_py_str(result);
  Py_DECREF(result);
  return text;
}

char* STT_ErrorCodeToErrorMessage(int error_code) {
  const char* message = "Unknown error, please make sure you are using the "
                        "correct native binary.";
  switch (error_code) {
    case STT_ERR_OK: message = "No error."; break;
    case STT_ERR_NO_MODEL: message = "Missing model information."; break;
    case STT_ERR_INVALID_ALPHABET:
      message = "Invalid alphabet embedded in model. (Data corruption?)";
      break;
    case STT_ERR_INVALID_SHAPE: message = "Invalid model shape."; break;
    case STT_ERR_INVALID_SCORER: message = "Invalid scorer file."; break;
    case STT_ERR_MODEL_INCOMPATIBLE: message = "Incompatible model."; break;
    case STT_ERR_SCORER_NOT_ENABLED:
      message = "External scorer is not enabled.";
      break;
    case STT_ERR_SCORER_UNREADABLE:
      message = "Could not read scorer file.";
      break;
    case STT_ERR_SCORER_INVALID_LM:
      message = "Could not recognize language model header in scorer.";
      break;
    case STT_ERR_SCORER_NO_TRIE:
      message = "Reached end of scorer file before loading vocabulary trie.";
      break;
    case STT_ERR_SCORER_INVALID_TRIE:
      message = "Invalid magic in trie header.";
      break;
    case STT_ERR_SCORER_VERSION_MISMATCH:
      message = "Scorer file version does not match expected version.";
      break;
    case STT_ERR_FAIL_CREATE_STREAM: message = "Error creating the stream."; break;
    case STT_ERR_FAIL_RUN_SESS: message = "Failed to run the session."; break;
    case STT_ERR_FAIL_CREATE_MODEL:
      message = "Could not allocate model state.";
      break;
    case STT_ERR_FAIL_INSERT_HOTWORD:
      message = "Could not insert hot-word.";
      break;
    case STT_ERR_FAIL_CLEAR_HOTWORD:
      message = "Could not clear hot-words.";
      break;
    case STT_ERR_FAIL_ERASE_HOTWORD:
      message = "Could not erase hot-word.";
      break;
  }
  return strdup(message);
}

}  // extern "C"
