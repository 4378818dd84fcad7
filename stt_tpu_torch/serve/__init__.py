from stt_tpu_torch.serve.model import (
    CandidateTranscript,
    Metadata,
    Model,
    Stream,
    TokenMetadata,
)
from stt_tpu_torch.serve.pool import PooledStream, StreamPool

__all__ = ["CandidateTranscript", "Metadata", "Model", "PooledStream", "Stream", "StreamPool",
           "TokenMetadata"]
