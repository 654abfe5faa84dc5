from xkv_tpu_torch.engine.batching import BatchedEngine, Request
from xkv_tpu_torch.engine.engine import InferenceEngine

__all__ = ["BatchedEngine", "InferenceEngine", "Request"]
