from stt_tpu_torch.ops.lstm_kernel import lstm_fused, lstm_recurrence
from stt_tpu_torch.ops.lstm_train import lstm_train, lstm_train_bwd, lstm_train_fwd

__all__ = ["lstm_fused", "lstm_recurrence", "lstm_train", "lstm_train_bwd", "lstm_train_fwd"]
