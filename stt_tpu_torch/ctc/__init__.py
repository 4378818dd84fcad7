from stt_tpu_torch.ctc.greedy import best_path, collapse_best_path, greedy_decode
from stt_tpu_torch.ctc.loss import ctc_loss

__all__ = ["best_path", "collapse_best_path", "ctc_loss", "greedy_decode"]
