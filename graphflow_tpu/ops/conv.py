"""CNN ops: Conv1D/Conv2D/MaxPool2D/AveragePool2D (reference L2 op library).

Layout convention follows the reference Tensor3D: images are [H, W, C]
(depth last).  Internally a singleton batch axis is added so XLA's fused
convolution kernels (cuDNN on the GPU) are used; callers can also pass [N, H, W, C]
batches directly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def _ensure_batched(x):
    if x.ndim == 3:
        return x[None], True
    return x, False


def conv2d(x, filt, bias=None, stride: int = 1, pad: int = 0):
    """``Conv2D.h:39-89``: 2-D convolution with symmetric zero pad + stride.

    x: [H, W, C1] (or [N, H, W, C1]); filt: [KH, KW, C1, C2] (reference
    Tensor4D layout); bias: [C1, C2] — the reference adds
    ``sum_{c1} bias[c1, c2]`` to every output pixel (``Conv2D.h:76-86``),
    reproduced faithfully.
    """
    x, squeeze = _ensure_batched(x)
    out = lax.conv_general_dilated(
        x, filt,
        window_strides=(stride, stride),
        padding=[(pad, pad), (pad, pad)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    if bias is not None:
        out = out + bias.sum(axis=0)[None, None, None, :]
    return out[0] if squeeze else out


def conv1d(x, filt, bias=None, stride: int = 1, pad: int = 0):
    """``Conv1D.h``: 1-D convolution. x: [L, C1]; filt: [K, C1, C2];
    bias: [C2] or [C1, C2] (summed over C1 as in conv2d)."""
    out = lax.conv_general_dilated(
        x[None], filt,
        window_strides=(stride,),
        padding=[(pad, pad)],
        dimension_numbers=("NHC", "HIO", "NHC"),
    )[0]
    if bias is not None:
        b = bias.sum(axis=0) if bias.ndim == 2 else bias
        out = out + b[None, :]
    return out


def max_pool2d(x, window: int, stride: int):
    """``MaxPool2D.h:33-63``: VALID max pooling (argmax positions handled by
    the VJP of reduce_window automatically)."""
    x, squeeze = _ensure_batched(x)
    out = lax.reduce_window(
        x, -jnp.inf, lax.max,
        window_dimensions=(1, window, window, 1),
        window_strides=(1, stride, stride, 1),
        padding="VALID",
    )
    return out[0] if squeeze else out


def avg_pool2d(x, window: int, stride: int):
    """``AveragePool2D.h``: VALID average pooling."""
    x, squeeze = _ensure_batched(x)
    out = lax.reduce_window(
        x, 0.0, lax.add,
        window_dimensions=(1, window, window, 1),
        window_strides=(1, stride, stride, 1),
        padding="VALID",
    ) / float(window * window)
    return out[0] if squeeze else out
