"""Training: the learned-compressor zoo, its trainer, and LM training."""

from xkv_tpu_torch.train.compressors import (  # noqa: F401
    ConvCompressor,
    EnhancedConvCompressor,
    Dual1DConvCompressor,
    VAEConvCompressor,
    IdentityCompressor,
    make_compressor,
)
from xkv_tpu_torch.train.trainer import CompressorTrainer, TrainConfig  # noqa: F401
