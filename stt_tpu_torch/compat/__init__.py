"""Bridges to reference-format artifacts (the port's copy of
`stt_tpu.compat`): the .tflite reader (`tflite`, numpy only), the .tflite
writer (`tflite_export`) and the TF1 checkpoint reader (`tf_checkpoint`);
the last two import TensorFlow when they are called, never on import."""
