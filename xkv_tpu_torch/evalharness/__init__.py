from xkv_tpu_torch.evalharness.dataset import Dataset  # noqa: F401
from xkv_tpu_torch.evalharness.evaluator import Evaluator  # noqa: F401
