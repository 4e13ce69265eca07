"""Int8 quantized acoustic-model path.

Reproduces the reference's latent quantized-GEMM capability with its exact
quantization semantics (reference src/matrix.cc:348-420): per-tensor affine
min/max quantization to uint8 with scale = (max-min)/255 and
zero_point = round(-min/scale), and C = sA*sB*(A-zpA)(B-zpB).  The reference
implemented and tested this via gemmlowp but never wired it into the nnet
(src/nnet.cc:29 uses only the float path); here it IS wired, behind the
`quantized = true` config key.

Execution: values are stored shifted to int8 (v-128) and one s8 x s8 -> s32
`lax.dot_general` does the matmul (XLA picks the library GEMM); the
zero-point cross terms are rank-1 corrections applied in the f32 epilogue:

  (a - zpA)(b - zpB) = a'b' + cB*rowsum(a') + cA*colsum(b') + K*cA*cB
  with a' = a-128, b' = b-128, cA = 128-zpA, cB = 128-zpB.

Accuracy target: max_error / result_range < 1% (reference
test/gemm_test.cc:120).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from catears_tpu.am.nnet import NnetDef, NnetParams, narrow, normalize_rms, splice


class QuantizedTensor(NamedTuple):
    values: jnp.ndarray  # int8, stored as (uint8 value - 128)
    scale: jnp.ndarray  # f32 scalar
    zero_point: jnp.ndarray  # i32 scalar (uint8 domain)


def quantize(x: jnp.ndarray) -> QuantizedTensor:
    """Min/max affine quantization (reference Quantize semantics)."""
    mn = jnp.min(x)
    mx = jnp.max(x)
    scale = (mx - mn) / 255.0
    # Degenerate constant input (reference divides by zero here): pick a
    # scale that represents the constant exactly.
    flat_scale = jnp.where(mn == 0, 1.0, jnp.abs(mn) / 128.0)
    scale = jnp.where(scale <= 0, flat_scale, scale)
    zero_point = jnp.round(-mn / scale).astype(jnp.int32)
    q = jnp.clip(jnp.round(x / scale) + zero_point, 0, 255)
    return QuantizedTensor((q - 128).astype(jnp.int8),
                           scale.astype(jnp.float32), zero_point)


def quantize_static(x: jnp.ndarray, mn: float, mx: float) -> QuantizedTensor:
    """Affine quantization with a CALIBRATED range (deployment fast path).

    Same semantics as `quantize` but (mn, mx) are compile-time constants
    from offline calibration, so the min/max reductions vanish and the
    scale/zero-point fold into one fused mul+round+clip elementwise pass.
    Out-of-range activations saturate (standard post-training-quantization
    behavior; the 1%-of-range accuracy criterion is re-checked in tests).
    """
    mn = jnp.asarray(mn, jnp.float32)
    mx = jnp.asarray(mx, jnp.float32)
    flat_scale = jnp.where(mn == 0, 1.0, jnp.abs(mn) / 128.0)
    scale = jnp.where(mx - mn <= 0, flat_scale, (mx - mn) / 255.0)
    zero_point = jnp.round(-mn / scale).astype(jnp.int32)
    q = jnp.clip(jnp.round(x / scale) + zero_point, 0, 255)
    return QuantizedTensor((q - 128).astype(jnp.int8), scale, zero_point)


def matmul_s8(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """[M, K] s8 @ [K, N] s8 -> [M, N] s32, exact integer accumulation."""
    return jax.lax.dot_general(a, b, (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)


def qmatmul(aq: QuantizedTensor, bq: QuantizedTensor,
            colsum_b: jnp.ndarray = None) -> jnp.ndarray:
    """Quantized matmul with f32 dequant epilogue (MatMat_U8U8F32 parity).

    colsum_b: optional precomputed f32 column sums of bq.values (weights
    are static, so quantize_params computes them once).
    """
    a, b = aq.values, bq.values
    k = a.shape[1]
    dot = matmul_s8(a, b).astype(jnp.float32)
    ca = (128 - aq.zero_point).astype(jnp.float32)
    cb = (128 - bq.zero_point).astype(jnp.float32)
    rowsum_a = jnp.sum(a.astype(jnp.int32), axis=1).astype(jnp.float32)
    if colsum_b is None:
        colsum_b = jnp.sum(b.astype(jnp.int32), axis=0).astype(jnp.float32)
    acc = (dot + cb * rowsum_a[:, None] + ca * colsum_b[None, :]
           + k * ca * cb)
    return aq.scale * bq.scale * acc


def quantize_params(nnet_def: NnetDef, params: NnetParams) -> List[dict]:
    """Pre-quantize every linear layer's weights (bias stays f32)."""
    out = []
    for layer, p in zip(nnet_def, params):
        if layer[0] == "linear":
            wq = quantize(p["w"])
            colsum = jnp.sum(wq.values.astype(jnp.int32),
                             axis=0).astype(jnp.float32)
            out.append({"wq": wq, "b": p["b"], "colsum": colsum})
        else:
            out.append(p)
    return out


def calibrate_ranges(nnet_def: NnetDef, params: NnetParams,
                     qparams: List[dict], xs, margin: float = 0.05,
                     guard: bool = False) -> None:
    """Record each linear's input (min, max) from float forward passes.

    Runs the FLOAT stack on representative features (ONE array or a LIST
    of per-utterance arrays — multi-utterance calibration tracks the
    running min/max across all of them) and attaches the observed
    activation range (+margin headroom for unseen data) to each linear's
    qparams entry; nnet_forward_quant then uses the reduction-free
    quantize_static path.  Out-of-range activations saturate by default
    (standard post-training quantization); pass guard=True to fall back
    to exact dynamic quantization whenever an input exceeds the
    calibrated range — that re-adds the min/max reductions but bounds
    the saturation error at zero.  The reference has no calibration (its
    gemmlowp path re-derives ranges per GEMM, src/matrix.cc:348-420) —
    this is the deployment-standard refinement of the same affine
    semantics.
    """
    from catears_tpu.am.nnet import nnet_forward

    if not isinstance(xs, (list, tuple)):
        xs = [xs]
    ranges: List[Optional[Tuple[float, float]]] = [None] * len(nnet_def)
    for x in xs:
        x = jnp.asarray(x)
        for i, (layer, p) in enumerate(zip(nnet_def, params)):
            if layer[0] == "linear":
                mn = float(jnp.min(x))
                mx = float(jnp.max(x))
                if ranges[i] is None:
                    ranges[i] = (mn, mx)
                else:
                    ranges[i] = (min(ranges[i][0], mn),
                                 max(ranges[i][1], mx))
            x = nnet_forward(nnet_def[i:i + 1], [p], x)
    # Guardedness is encoded in the KEY ("grng" vs "rng"): dict keys are
    # static in jax pytrees, values are traced leaves — a bool leaf would
    # break Python branching under jit.
    key = "grng" if guard else "rng"
    for i, r in enumerate(ranges):
        if r is not None:
            pad = margin * max(r[1] - r[0], 1e-6)
            qparams[i].pop("rng", None)
            qparams[i].pop("grng", None)
            qparams[i][key] = (r[0] - pad, r[1] + pad)


def calibration_coverage(nnet_def: NnetDef, params: NnetParams,
                         qparams: List[dict], xs) -> List[float]:
    """Fraction of activations inside each linear's calibrated range.

    Validation helper: run held-out utterances through the float stack
    and report per-linear in-range fractions — a coverage well below 1.0
    means the calibration set under-represents the deployment data and
    the saturating static path will distort (use more calibration
    utterances, a larger margin, or guard=True).
    """
    from catears_tpu.am.nnet import nnet_forward

    if not isinstance(xs, (list, tuple)):
        xs = [xs]
    inside = [0] * len(nnet_def)
    total = [0] * len(nnet_def)
    for x in xs:
        x = jnp.asarray(x)
        for i, (layer, p) in enumerate(zip(nnet_def, params)):
            if layer[0] == "linear" and (
                    "rng" in qparams[i] or "grng" in qparams[i]):
                mn, mx = qparams[i].get("rng") or qparams[i]["grng"]
                inside[i] += int(jnp.sum((x >= mn) & (x <= mx)))
                total[i] += x.size
            x = nnet_forward(nnet_def[i:i + 1], [p], x)
    return [inside[i] / total[i] for i in range(len(nnet_def)) if total[i]]


def nnet_forward_quant(nnet_def: NnetDef, qparams: List[dict],
                       x: jnp.ndarray) -> jnp.ndarray:
    """Layer stack with int8 linears.

    Activations quantize with the calibrated static range when present
    ("rng" in the layer's qparams, see calibrate_ranges), else with a
    dynamic per-call min/max (exact reference Quantize semantics).
    """
    for layer, p in zip(nnet_def, qparams):
        kind = layer[0]
        if kind == "linear":
            if "grng" in p:
                # Guarded static path: exact dynamic quantization whenever
                # the input exceeds the calibrated range (costs the
                # min/max reductions back, bounds saturation error at 0).
                mn = jnp.minimum(jnp.min(x), p["grng"][0])
                mx = jnp.maximum(jnp.max(x), p["grng"][1])
                xq = quantize_static(x, mn, mx)
            elif "rng" in p:
                xq = quantize_static(x, *p["rng"])
            else:
                xq = quantize(x)
            x = qmatmul(xq, p["wq"], colsum_b=p.get("colsum")) + p["b"]
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
