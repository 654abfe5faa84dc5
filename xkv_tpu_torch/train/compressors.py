"""Learned KV-cache compressor zoo (``torch.nn``).

The port's counterpart of ``xkv_tpu/train/compressors.py`` (itself the
rebuild of the reference fork's `src/compressors/compressor.py:47-822`):
the same five compressors, parameter names and layouts, so that a flax
parameter tree carries over one to one (``params_from_flax``,
``params_to_flax``).

Flax's semantics, which PyTorch's defaults do not share, reproduced here:
  * input layout: channels last, (batch, num_layers, seq, features) with
    features = 2 * hkv * hd (K concatenated with V);
  * kernels laid out (k..., in, out), Dense kernels (in, out), biases (out,);
  * ``nn.Conv`` pads "SAME" as ``lax`` does: a stride-2 conv pads unevenly
    (``_same_pads``);
  * ``nn.ConvTranspose`` (``transpose_kernel=False``) is ``lax.conv_transpose``:
    the input dilated by the stride, padded as ``_transpose_pads`` says
    ((2, 1) for kernel 3, stride 2), then correlated with the unflipped
    kernel; here a ``conv_transpose`` over the spatially flipped kernel,
    cropped to those rows (``conv_transpose_same``);
  * ``nn.gelu`` is the tanh approximation;
  * init: lecun-normal kernels (a normal truncated at two standard
    deviations, variance 1 / fan_in), zero biases, drawn from an explicit
    ``torch.Generator`` (JAX's key stream cannot be reproduced).

The VAE's noise is an explicit ``eps`` or drawn from a ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


_ACTS = {"gelu": gelu, "relu": F.relu, "silu": F.silu, "none": lambda v: v}


# ------------------------------------------------------------ flax layers
def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """``lax`` "SAME" padding of one spatial dim: ceil(n / s) outputs, the
    odd row of padding on the high side."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _transpose_pads(k: int, s: int) -> Tuple[int, int]:
    """``lax.conv_transpose``'s "SAME" padding of the dilated input."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    return pad_a, pad_len - pad_a


def _conv_fn(nd: int, transpose: bool):
    return {(1, False): F.conv1d, (2, False): F.conv2d,
            (1, True): F.conv_transpose1d, (2, True): F.conv_transpose2d}[(nd, transpose)]


def conv_same(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
              strides: Sequence[int]) -> torch.Tensor:
    """flax ``nn.Conv(padding="SAME")``: x (N, *spatial, C) channels last,
    kernel (*k, C, F) -> (N, *ceil(spatial / strides), F)."""
    nd = kernel.dim() - 2
    pads = []
    for n, k, s in zip(reversed(x.shape[1:-1]), reversed(kernel.shape[:nd]), reversed(strides)):
        pads += _same_pads(n, k, s)
    xc = F.pad(x.movedim(-1, 1), pads)
    w = kernel.permute(nd + 1, nd, *range(nd))
    return _conv_fn(nd, False)(xc, w, bias, stride=tuple(strides)).movedim(1, -1)


def conv_transpose_same(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                        strides: Sequence[int]) -> torch.Tensor:
    """flax ``nn.ConvTranspose(padding="SAME")`` (``lax.conv_transpose``,
    ``transpose_kernel=False``): x (N, *spatial, C), kernel (*k, C, F) ->
    (N, *spatial * strides, F). Row j of the lax result is row
    j + k - 1 - pad_lo of the full transposed convolution over the flipped
    kernel; rows past the full result are windows over padding alone."""
    nd = kernel.dim() - 2
    w = kernel.flip(dims=tuple(range(nd))).permute(nd, nd + 1, *range(nd))
    y = _conv_fn(nd, True)(x.movedim(-1, 1), w, None, stride=tuple(strides))
    for d in range(nd):
        n, k, s = x.shape[1 + d], kernel.shape[d], strides[d]
        lo, hi = _transpose_pads(k, s)
        start = k - 1 - lo
        length = (n - 1) * s + 1 + lo + hi - k + 1
        short = start + length - y.shape[2 + d]
        if short > 0:
            pad = [0, 0] * (nd - 1 - d) + [0, short]
            y = F.pad(y, pad)
        y = y.narrow(2 + d, start, length)
    return (y + bias.reshape(-1, *([1] * nd))).movedim(1, -1)


def _lecun_normal_(t: torch.Tensor, generator: torch.Generator) -> None:
    """flax's ``lecun_normal()`` in place: variance 1 / fan_in (fan_in: every
    axis but the last), a standard normal truncated at +-2 and rescaled to
    unit variance, drawn by inverting its CDF from uniforms."""
    fan_in = math.prod(t.shape[:-1])
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    cdf = lambda v: 0.5 * (1.0 + math.erf(v / math.sqrt(2.0)))  # noqa: E731
    lo, hi = cdf(-2.0), cdf(2.0)
    u = torch.rand(t.shape, generator=generator, dtype=torch.float64)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0)
    with torch.no_grad():
        t.copy_((z.clamp(-2.0, 2.0) * std).to(t.dtype))


class _Layer(nn.Module):
    """A flax Conv, ConvTranspose or Dense: ``kernel`` in flax's layout and
    ``bias``, the names flax gives them."""

    def __init__(self, in_features: int, features: int, kernel_size: Tuple[int, ...] = (),
                 strides: Optional[Tuple[int, ...]] = None, transpose: bool = False):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(*kernel_size, in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.strides = tuple(strides) if strides else (1,) * len(kernel_size)
        self.transpose = transpose

    def reset_parameters(self, generator: torch.Generator) -> None:
        _lecun_normal_(self.kernel, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kernel.dim() == 2:  # Dense
            return x @ self.kernel + self.bias
        fn = conv_transpose_same if self.transpose else conv_same
        return fn(x, self.kernel, self.bias, self.strides)


class _Compressor(nn.Module):
    """Shared init for the zoo: every ``_Layer`` drawn from one generator
    in registration order."""

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, _Layer):
                m.reset_parameters(generator)


def _crop_pad(out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Crop / zero-pad out's (layers, seq) dims to x's (stride remainders)."""
    out = out[:, : x.shape[1], : x.shape[2], :]
    return F.pad(out, (0, 0, 0, x.shape[2] - out.shape[2], 0, x.shape[1] - out.shape[1]))


class IdentityCompressor(_Compressor):
    """Passthrough baseline (reference `src/compressors/identity_compressor.py`)."""

    def __init__(self, in_features: int):
        super().__init__()

    def forward(self, x, train: bool = False):
        return x

    def compress(self, x):
        return x

    def decompress(self, z):
        return z

    @staticmethod
    def compression_ratio() -> float:
        return 1.0


class ConvCompressor(_Compressor):
    """2D strided-conv encoder/decoder over (layers, seq)
    (reference `ConvolutionalCompressor`, `compressor.py:114-224`)."""

    def __init__(self, in_features: int, features: int = 64, latent_features: int = 16,
                 strides: Tuple[int, int] = (2, 2)):
        super().__init__()
        self.enc1 = _Layer(in_features, features, (3, 3), strides)
        self.enc2 = _Layer(features, latent_features, (3, 3))
        self.dec1 = _Layer(latent_features, features, (3, 3), strides, transpose=True)
        self.dec_out = _Layer(features, in_features)

    def forward(self, x, train: bool = False):
        h = gelu(self.enc1(x))
        z = self.enc2(h)
        h = gelu(self.dec1(z))
        return _crop_pad(self.dec_out(h), x)


class Dual1DConvCompressor(_Compressor):
    """1D conv along the layer axis, then along the sequence axis
    (reference `Dual1DConvolutionalCompressor`, `compressor.py:643-822`),
    the variant of the reference fork's one recorded training run
    (compression_ratio 32)."""

    def __init__(self, in_features: int, layer_stride: int = 2, seq_stride: int = 2,
                 feature_ratio: int = 8, activation: str = "gelu"):
        super().__init__()
        f = in_features
        latent_f = max(1, f // feature_ratio)
        self.layer_stride, self.seq_stride = layer_stride, seq_stride
        self.feature_ratio, self.activation = feature_ratio, activation
        self._act = _ACTS[activation]
        self.enc_layer = _Layer(f, f, (3,), (layer_stride,))
        self.enc_seq = _Layer(f, latent_f, (3,), (seq_stride,))
        self.dec_seq = _Layer(latent_f, f, (3,), (seq_stride,), transpose=True)
        self.dec_layer = _Layer(f, f, (3,), (layer_stride,), transpose=True)

    def forward(self, x, train: bool = False):
        b, L, s, f = x.shape
        # encode: conv along layers (seq as batch), then along seq
        h = x.permute(0, 2, 1, 3).reshape(b * s, L, f)
        h = self._act(self.enc_layer(h))
        L2 = h.shape[1]
        h = h.reshape(b, s, L2, f).permute(0, 2, 1, 3).reshape(b * L2, s, f)
        h = self._act(self.enc_seq(h))
        s2, latent_f = h.shape[1], h.shape[2]
        z = h.reshape(b, L2, s2, latent_f)
        # decode: transpose convs in reverse order
        h = z.reshape(b * L2, s2, latent_f)
        h = self._act(self.dec_seq(h))
        h = h[:, :s, :]
        h = h.reshape(b, L2, s, f).permute(0, 2, 1, 3).reshape(b * s, L2, f)
        h = self.dec_layer(h)
        h = h[:, :L, :]
        return h.reshape(b, s, L, f).permute(0, 2, 1, 3)

    def compression_ratio(self) -> float:
        return float(self.layer_stride * self.seq_stride * self.feature_ratio)


class VAEConvCompressor(_Compressor):
    """Conv compressor with a variational latent (mu / logvar heads,
    reparameterisation, KL) - reference `VAEConvolutionalCompressor`,
    `compressor.py:438-625`. In training the noise is ``eps`` when given,
    else drawn from ``generator``."""

    def __init__(self, in_features: int, features: int = 64, latent_features: int = 16,
                 strides: Tuple[int, int] = (2, 2)):
        super().__init__()
        self.enc = _Layer(in_features, features, (3, 3), strides)
        self.mu = _Layer(features, latent_features, (3, 3))
        self.logvar = _Layer(features, latent_features, (3, 3))
        self.dec = _Layer(latent_features, features, (3, 3), strides, transpose=True)
        self.dec_out = _Layer(features, in_features)

    def forward(self, x, train: bool = False, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        h = gelu(self.enc(x))
        mu, logvar = self.mu(h), self.logvar(h)
        if train:
            if eps is None:
                eps = torch.randn(mu.shape, generator=generator, dtype=mu.dtype,
                                  device=mu.device)
            z = mu + torch.exp(0.5 * logvar) * eps
        else:
            z = mu
        h = gelu(self.dec(z))
        return _crop_pad(self.dec_out(h), x), mu, logvar


def kl_divergence(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL(N(mu, sigma) || N(0, 1)), meaned (reference `compressor.py:561-625`)."""
    return -0.5 * torch.mean(1 + logvar - mu**2 - torch.exp(logvar))


class EnhancedConvCompressor(_Compressor):
    """Conv compressor with residual refinement and channel attention
    (reference `EnhancedConvolutionalCompressor`, `compressor.py:243-417`:
    strided conv + SE-style channel gating + residual blocks)."""

    def __init__(self, in_features: int, features: int = 64, latent_features: int = 16,
                 strides: Tuple[int, int] = (2, 2), num_res_blocks: int = 2, se_ratio: int = 4):
        super().__init__()
        self.num_res_blocks = num_res_blocks
        self.enc = _Layer(in_features, features, (3, 3), strides)
        for i in range(num_res_blocks):
            self._res_layers(f"enc_res{i}", features)
        self.enc_ca_se1 = _Layer(features, max(1, features // se_ratio))
        self.enc_ca_se2 = _Layer(max(1, features // se_ratio), features)
        self.to_latent = _Layer(features, latent_features, (3, 3))
        self.dec = _Layer(latent_features, features, (3, 3), strides, transpose=True)
        for i in range(num_res_blocks):
            self._res_layers(f"dec_res{i}", features)
        self.dec_out = _Layer(features, in_features)

    def _res_layers(self, name: str, f: int) -> None:
        self.add_module(f"{name}_c1", _Layer(f, f, (3, 3)))
        self.add_module(f"{name}_c2", _Layer(f, f, (3, 3)))

    def _res_block(self, x, name: str):
        h = gelu(getattr(self, f"{name}_c1")(x))
        h = getattr(self, f"{name}_c2")(h)
        return gelu(x + h)

    def _channel_attention(self, x):
        # Squeeze-and-excite over the feature axis (reference :398-417).
        pooled = x.mean(dim=(1, 2))
        h = F.relu(self.enc_ca_se1(pooled))
        gate = torch.sigmoid(self.enc_ca_se2(h))
        return x * gate[:, None, None, :]

    def forward(self, x, train: bool = False):
        h = gelu(self.enc(x))
        for i in range(self.num_res_blocks):
            h = self._res_block(h, f"enc_res{i}")
        h = self._channel_attention(h)
        z = self.to_latent(h)
        h = gelu(self.dec(z))
        for i in range(self.num_res_blocks):
            h = self._res_block(h, f"dec_res{i}")
        return _crop_pad(self.dec_out(h), x)


KINDS = {
    "identity": IdentityCompressor,
    "conv": ConvCompressor,
    "enhanced": EnhancedConvCompressor,
    "dual1d": Dual1DConvCompressor,
    "vae": VAEConvCompressor,
}


def make_compressor(kind: str, in_features: int, **kwargs) -> nn.Module:
    """A compressor of ``kind`` for inputs of ``in_features`` features (flax
    infers them at init; a ``torch.nn.Module`` needs them to exist)."""
    if kind not in KINDS:
        raise ValueError(f"unknown compressor {kind!r}; options {list(KINDS)}")
    return KINDS[kind](in_features, **kwargs)


# ------------------------------------------------------------ flax trees
def params_to_flax(module: nn.Module) -> Dict[str, Dict[str, torch.Tensor]]:
    """The module's parameters as flax's tree: {layer: {"kernel", "bias"}},
    detached views of the live tensors."""
    tree: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, p in module.named_parameters():
        layer, leaf = name.rsplit(".", 1)
        tree.setdefault(layer, {})[leaf] = p.detach()
    return tree


def params_from_flax(module: nn.Module, tree) -> nn.Module:
    """Carry a flax parameter tree ({layer: {"kernel", "bias"}} of arrays)
    into ``module`` in place. The layer names, leaves and shapes must match
    exactly. Returns the module."""
    want = {}
    for layer, leaves in tree.items():
        for leaf, arr in leaves.items():
            want[f"{layer}.{leaf}"] = arr
    have = dict(module.named_parameters())
    if sorted(want) != sorted(have):
        raise ValueError(f"parameter names differ: tree {sorted(want)}, module {sorted(have)}")
    with torch.no_grad():
        for name, p in have.items():
            src = want[name]
            src = src if isinstance(src, torch.Tensor) else torch.tensor(np.asarray(src))
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} against {tuple(p.shape)}")
            p.copy_(src.to(device=p.device, dtype=p.dtype))
    return module
