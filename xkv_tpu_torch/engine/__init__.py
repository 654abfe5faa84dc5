from xkv_tpu_torch.engine.engine import InferenceEngine

__all__ = ["InferenceEngine"]
