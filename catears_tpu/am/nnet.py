"""nnet3-style layer zoo as pure JAX functions.

Functional parity with the reference layer stack (reference src/nnet.{h,cc}):
Linear (y = xW + b, file stores W as [in, out]), ReLU, Normalize (scale each
row to rms 1), Softmax, LogSoftmax (rowwise), Splice (frame-context concat
with edge clamping, src/nnet.cc:50-75), BatchNorm (precomputed scale/offset
elementwise), Narrow (drop left/right context rows, src/nnet.cc:182-202).

The whole stack is a pure function over a [T, D] (or [B, T, D]) array;
splice is a static gather; everything jits into one fused XLA program
instead of the reference's per-layer matrix ping-pong.

Linears run at LINEAR_PRECISION = HIGHEST (true f32).  A GPU's default
f32 matmul is TF32 (~10 mantissa bits), which moved the TDNN's
log-likelihoods ~300x further from a float64 forward than HIGHEST did on
the card (PERF.md findings); the AM is a small share of a decode, so
full precision costs little end to end.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from catears_tpu.io import binfmt
from catears_tpu.io.binfmt import NnetSpec
from catears_tpu.utils.errors import CorruptionError

# Static layer definition: tuple of ("kind", *static_args) entries.
NnetDef = Tuple[Tuple[Any, ...], ...]
# Per-layer parameter dicts (possibly empty), aligned with NnetDef.
NnetParams = List[Dict[str, jnp.ndarray]]
LINEAR_PRECISION = jax.lax.Precision.HIGHEST


def build_nnet(spec: NnetSpec) -> Tuple[NnetDef, NnetParams]:
    """Split an NN02 spec into a static layer structure + parameter pytree."""
    layer_defs: List[Tuple[Any, ...]] = []
    params: NnetParams = []
    for layer in spec.layers:
        if layer.kind == binfmt.LAYER_LINEAR:
            layer_defs.append(("linear",))
            params.append({"w": jnp.asarray(layer.weight, jnp.float32),
                           "b": jnp.asarray(layer.bias, jnp.float32)})
        elif layer.kind == binfmt.LAYER_RELU:
            layer_defs.append(("relu",))
            params.append({})
        elif layer.kind == binfmt.LAYER_NORMALIZE:
            layer_defs.append(("normalize",))
            params.append({})
        elif layer.kind == binfmt.LAYER_SOFTMAX:
            layer_defs.append(("softmax",))
            params.append({})
        elif layer.kind == binfmt.LAYER_LOGSOFTMAX:
            layer_defs.append(("logsoftmax",))
            params.append({})
        elif layer.kind == binfmt.LAYER_SPLICE:
            layer_defs.append(("splice", tuple(layer.indices)))
            params.append({})
        elif layer.kind == binfmt.LAYER_BATCHNORM:
            layer_defs.append(("batchnorm",))
            params.append({"scale": jnp.asarray(layer.scale, jnp.float32),
                           "offset": jnp.asarray(layer.offset, jnp.float32)})
        elif layer.kind == binfmt.LAYER_NARROW:
            layer_defs.append(("narrow", layer.narrow_left, layer.narrow_right))
            params.append({})
        else:
            raise CorruptionError(f"unknown layer kind {layer.kind}")
    return tuple(layer_defs), params


def splice(x: jnp.ndarray, indices: Sequence[int]) -> jnp.ndarray:
    """[T, D] -> [T, len(indices)*D]: concat context frames, edges clamped."""
    t = x.shape[0]
    offs = jnp.asarray(indices, jnp.int32)
    idx = jnp.clip(jnp.arange(t, dtype=jnp.int32)[:, None] + offs[None, :],
                   0, t - 1)
    return x[idx].reshape(t, len(indices) * x.shape[1])


def narrow(x: jnp.ndarray, left: int, right: int) -> jnp.ndarray:
    """Drop `left` head rows and `right` tail rows (no-op if too few rows)."""
    t = x.shape[0]
    if t <= left + right:
        return x
    return x[left:t - right]


def normalize_rms(x: jnp.ndarray) -> jnp.ndarray:
    """Scale each row so its root-mean-square is 1 (NormalizeLayer)."""
    d = x.shape[-1]
    squared_sum = jnp.sum(x * x, axis=-1, keepdims=True)
    return x * jnp.sqrt(d / squared_sum)


def nnet_forward(nnet_def: NnetDef, params: NnetParams,
                 x: jnp.ndarray) -> jnp.ndarray:
    """Run the layer stack on [T, D] features. nnet_def must be static."""
    for layer, p in zip(nnet_def, params):
        kind = layer[0]
        if kind == "linear":
            x = jnp.dot(x, p["w"], precision=LINEAR_PRECISION,
                        preferred_element_type=jnp.float32) + p["b"]
        elif kind == "relu":
            x = jnp.maximum(x, 0.0)
        elif kind == "normalize":
            x = normalize_rms(x)
        elif kind == "softmax":
            x = jax.nn.softmax(x, axis=-1)
        elif kind == "logsoftmax":
            x = jax.nn.log_softmax(x, axis=-1)
        elif kind == "splice":
            x = splice(x, layer[1])
        elif kind == "batchnorm":
            x = x * p["scale"] + p["offset"]
        elif kind == "narrow":
            x = narrow(x, layer[1], layer[2])
        else:
            raise ValueError(f"unknown layer kind {kind}")
    return x


def output_dim(nnet_def: NnetDef, params: NnetParams, input_dim: int) -> int:
    """Static output dimension of the stack."""
    d = input_dim
    for layer, p in zip(nnet_def, params):
        kind = layer[0]
        if kind == "linear":
            d = p["w"].shape[1]
        elif kind == "splice":
            d = d * len(layer[1])
    return d


def rows_consumed(nnet_def: NnetDef) -> Tuple[int, int]:
    """Total (left, right) rows consumed by Narrow layers."""
    left = right = 0
    for layer in nnet_def:
        if layer[0] == "narrow":
            left += layer[1]
            right += layer[2]
    return left, right
