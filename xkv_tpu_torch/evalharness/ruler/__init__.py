from xkv_tpu_torch.evalharness.ruler.tasks import SYNTHETIC_TASKS, TASKS  # noqa: F401
from xkv_tpu_torch.evalharness.ruler.generators import generate_task  # noqa: F401
