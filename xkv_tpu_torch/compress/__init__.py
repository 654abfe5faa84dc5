from xkv_tpu_torch.compress.svd import (  # noqa: F401
    LowRankFactors,
    factorize,
    randomized_svd,
    reconstruct,
    truncated_svd,
)
from xkv_tpu_torch.compress.slerp import (  # noqa: F401
    minicache_merge,
    slerp_merge_rows,
)
