"""Acoustic model: nnet + log-prior + transition->pdf map, with streaming.

Parity with reference src/am.{h,cc}: config keys `nnet`, `prior`,
`left_context`, `right_context`, `chunk_size`, `num_pdfs`, `tid2pdf`; output
is nnet log-softmax minus log-prior (pseudo log-likelihood, src/am.cc:108-112);
streaming replicates the first frame x left_context at utterance start and
the last frame x right_context at end-of-stream (src/am.cc:115-164).

The whole utterance (or a chunk) is a single [T, 40] -> [T', P]
jit program; the streaming wrapper batches frames into fixed chunk_size
programs so shapes stay static.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from catears_tpu.am.nnet import (
    NnetDef,
    NnetParams,
    build_nnet,
    nnet_forward,
)
from catears_tpu.io.binfmt import read_nnet_file, read_vec0_file
from catears_tpu.io.config import Configuration

FEAT_DIM = 40


def _bucket(n: int, base: int = 16) -> int:
    """Round row counts up to limit jit cache entries."""
    if n <= base:
        return base
    return 1 << (n - 1).bit_length()


@functools.partial(jax.jit, static_argnums=(0, 4))
def _am_forward_jit(nnet_def: NnetDef, params: NnetParams,
                    log_prior: jnp.ndarray, feats: jnp.ndarray,
                    quantized: bool = False) -> jnp.ndarray:
    if quantized:
        from catears_tpu.am.quant import nnet_forward_quant
        return nnet_forward_quant(nnet_def, params, feats) - log_prior
    return nnet_forward(nnet_def, params, feats) - log_prior


class AcousticModel:
    def __init__(self, nnet_def: NnetDef, params: NnetParams,
                 log_prior: np.ndarray, tid2pdf: np.ndarray,
                 left_context: int, right_context: int, chunk_size: int,
                 num_pdfs: int, quantized: bool = False):
        self.nnet_def = nnet_def
        self.float_params = params
        self.quantized = quantized
        if quantized:
            from catears_tpu.am.quant import quantize_params
            self.params = quantize_params(nnet_def, params)
        else:
            self.params = params
        self.log_prior = jnp.asarray(log_prior, jnp.float32)
        self.tid2pdf = np.asarray(tid2pdf, np.int32)
        self.left_context = left_context
        self.right_context = right_context
        self.chunk_size = chunk_size
        self.num_pdfs = num_pdfs

    def calibrate(self, padded_feats, margin: float = 0.05,
                  guard: bool = False) -> None:
        """Calibrate int8 activation ranges on representative features.

        padded_feats: [L + T + R, 40] context-padded fbank rows, or a LIST
        of such arrays (multi-utterance calibration).  After calibration
        every linear quantizes with a static range (no per-call min/max
        reductions); guard=True falls back to exact dynamic quantization
        whenever a held-out input exceeds the calibrated range (see
        am.quant.calibrate_ranges).  No-op on the float path.
        """
        if not self.quantized:
            return
        from catears_tpu.am.quant import calibrate_ranges
        if not isinstance(padded_feats, (list, tuple)):
            padded_feats = [padded_feats]
        calibrate_ranges(self.nnet_def, self.float_params, self.params,
                         [jnp.asarray(x, jnp.float32)
                          for x in padded_feats],
                         margin=margin, guard=guard)

    @classmethod
    def read(cls, conf: Configuration) -> "AcousticModel":
        spec = read_nnet_file(conf.get_path("nnet"))
        nnet_def, params = build_nnet(spec)
        prior = read_vec0_file(conf.get_path("prior"))
        log_prior = np.log(prior)
        left = conf.get_int("left_context")
        right = conf.get_int("right_context")
        chunk = conf.get_int("chunk_size")
        num_pdfs = conf.get_int("num_pdfs")
        tid2pdf = read_vec0_file(conf.get_path("tid2pdf"), np.int32)
        quantized = conf.get_string("quantized", "false").lower() in (
            "true", "1", "yes")
        return cls(nnet_def, params, log_prior, tid2pdf, left, right, chunk,
                   num_pdfs, quantized=quantized)

    # -- whole-utterance path (device, static shapes) ----------------------

    def forward_padded(self, feats: jnp.ndarray) -> jnp.ndarray:
        """[L + T + R, 40] context-padded features -> [T, P] log-likelihoods.

        Traceable; callers pad with replicated edge frames (equivalent to the
        reference's streaming padding + splice clamping).
        """
        if self.quantized:
            from catears_tpu.am.quant import nnet_forward_quant
            return nnet_forward_quant(self.nnet_def, self.params,
                                      feats) - self.log_prior
        return nnet_forward(self.nnet_def, self.params, feats) - self.log_prior

    def forward(self, feats: np.ndarray) -> np.ndarray:
        """[T, 40] -> [T, P]: replicate-pad edges then run the nnet once.

        Input length is bucketed (pad with replicated last frame, slice the
        output) so the jit cache stays small across utterance lengths.
        """
        t = feats.shape[0]
        if t == 0:
            return np.zeros((0, self.num_pdfs), np.float32)
        t_pad = _bucket(t)
        padded = np.concatenate([
            np.repeat(feats[:1], self.left_context, axis=0),
            feats,
            np.repeat(feats[-1:], self.right_context + (t_pad - t), axis=0),
        ])
        out = _am_forward_jit(self.nnet_def, self.params, self.log_prior,
                              jnp.asarray(padded, jnp.float32),
                              self.quantized)
        return np.asarray(out[:t])

    def pad_context(self, feats: np.ndarray) -> np.ndarray:
        return np.concatenate([
            np.repeat(feats[:1], self.left_context, axis=0),
            feats,
            np.repeat(feats[-1:], self.right_context, axis=0),
        ])


class AMStream:
    """Streaming chunked inference with reference padding semantics."""

    def __init__(self, am: AcousticModel):
        self.am = am
        self._buffer: Optional[np.ndarray] = None  # [n, 40]
        self._started = False

    def process(self, feats: np.ndarray) -> np.ndarray:
        """Append frames; emit chunk_size log-prob rows per full window."""
        am = self.am
        if feats.shape[0] == 0:
            return np.zeros((0, am.num_pdfs), np.float32)
        if not self._started:
            # Left padding: replicate the first frame (src/am.cc:119-124)
            self._buffer = np.repeat(feats[:1], am.left_context, axis=0)
            self._started = True
        self._buffer = np.concatenate([self._buffer, feats])

        outputs: List[np.ndarray] = []
        window = am.left_context + am.right_context + am.chunk_size
        while self._buffer.shape[0] >= window:
            batch_input = self._buffer[:window]
            out = _am_forward_jit(am.nnet_def, am.params, am.log_prior,
                                  jnp.asarray(batch_input, jnp.float32),
                                  am.quantized)
            outputs.append(np.asarray(out))
            self._buffer = self._buffer[am.chunk_size:]
        if not outputs:
            return np.zeros((0, am.num_pdfs), np.float32)
        return np.concatenate(outputs)

    def end_of_stream(self) -> np.ndarray:
        """Pad right context with the last frame and flush (src/am.cc:144-164)."""
        am = self.am
        if self._buffer is None or self._buffer.shape[0] == 0:
            return np.zeros((0, am.num_pdfs), np.float32)
        if (self._buffer.shape[0] + am.right_context
                <= am.left_context + am.right_context):
            return np.zeros((0, am.num_pdfs), np.float32)
        t = self._buffer.shape[0] - am.left_context  # valid output rows
        t_pad = _bucket(t)
        buf = np.concatenate([
            self._buffer,
            np.repeat(self._buffer[-1:],
                      am.right_context + (t_pad - t), axis=0),
        ])
        out = _am_forward_jit(am.nnet_def, am.params, am.log_prior,
                              jnp.asarray(buf, jnp.float32),
                              am.quantized)
        self._buffer = np.zeros((0, FEAT_DIM), np.float32)
        return np.asarray(out[:t])
