"""Log-mel filterbank frontend, batched and jit-compiled.

Numerical parity with the reference fbank chain (reference src/fbank.{h,cc}):
16 kHz, 25 ms frames / 10 ms shift, DC removal, pre-emphasis 0.97, Hamming
window, zero-pad 400 -> 512, power spectrum, 40 triangular mel bins computed
with Kaldi's mel formula on FFT bins [0, 256), floor at FLT_EPSILON, log.
Frame count uses the snip-edges formula (src/fbank.cc:35-42), and the
streaming wrapper carries leftover samples exactly like Fbank::Process
(src/fbank.cc:265-314).

Design: instead of a scalar split-radix FFT per frame (src/srfft.cc), all
frames are processed as one batch and the real DFT is a 400x514 matmul,
followed by the 257x40 mel matmul.  Both run at Precision.HIGHEST: Kaldi
parity is 1e-4 on features computed from 16-bit-scale samples, which a
reduced-precision (TF32) matmul does not hold.  Whether an FFT beats the
matmul on the GPU is unmeasured (ROADMAP S1 times the frontend).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

SAMPLE_RATE = 16000
FRAME_SHIFT = 160  # 10 ms
FRAME_LENGTH = 400  # 25 ms
PADDED_LENGTH = 512
NUM_BINS = 40
LOW_FREQ = 20.0
HIGH_FREQ = SAMPLE_RATE / 2
PREEMPH_COEFF = 0.97
FLT_EPSILON = np.float32(1.1920929e-07)
NUM_FFT_BINS = PADDED_LENGTH // 2  # mel bins cover [0, 256) like Kaldi


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + np.asarray(freq, np.float64) / 700.0)


def num_frames(num_samples: int) -> int:
    """snip-edges frame count (reference src/fbank.cc:35-42)."""
    if num_samples < FRAME_LENGTH:
        return 0
    return 1 + (num_samples - FRAME_LENGTH) // FRAME_SHIFT


@functools.lru_cache(maxsize=None)
def _constants() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(hamming[400], dft[400, 2*257], mel[257, 40]) as float32."""
    n = np.arange(FRAME_LENGTH, dtype=np.float64)
    hamming = 0.54 - 0.46 * np.cos(2.0 * np.pi * n / (FRAME_LENGTH - 1))

    # Real DFT of the zero-padded 512-sample frame, restricted to the 400
    # nonzero inputs: X[k] = sum_n x[n] exp(-2πi k n / 512).
    k = np.arange(NUM_FFT_BINS + 1, dtype=np.float64)
    ang = -2.0 * np.pi * np.outer(n, k) / PADDED_LENGTH
    dft = np.concatenate([np.cos(ang), np.sin(ang)], axis=1)

    # Kaldi triangular mel bins over fft bins [0, 256): weight nonzero only
    # strictly inside (left_mel, right_mel) (reference src/fbank.cc:126-154).
    fft_bin_width = SAMPLE_RATE / PADDED_LENGTH
    mel_low = mel_scale(LOW_FREQ)
    mel_high = mel_scale(HIGH_FREQ)
    mel_delta = (mel_high - mel_low) / (NUM_BINS + 1)
    bin_mels = mel_scale(fft_bin_width * np.arange(NUM_FFT_BINS))
    mel = np.zeros((NUM_FFT_BINS + 1, NUM_BINS), np.float64)
    for b in range(NUM_BINS):
        left = mel_low + b * mel_delta
        center = left + mel_delta
        right = center + mel_delta
        up = (bin_mels - left) / (center - left)
        down = (right - bin_mels) / (right - center)
        w = np.where(bin_mels <= center, up, down)
        inside = (bin_mels > left) & (bin_mels < right)
        mel[:NUM_FFT_BINS, b] = np.where(inside, w, 0.0)
    return (hamming.astype(np.float32), dft.astype(np.float32),
            mel.astype(np.float32))


def frame_signal(wave: jnp.ndarray, n_frames: int) -> jnp.ndarray:
    """[S] -> [T, 400] frame gather; indices clamped for padded tails."""
    idx = (jnp.arange(n_frames)[:, None] * FRAME_SHIFT
           + jnp.arange(FRAME_LENGTH)[None, :])
    idx = jnp.minimum(idx, wave.shape[-1] - 1)
    return jnp.take(wave, idx, axis=-1)


def fbank_from_frames(frames: jnp.ndarray) -> jnp.ndarray:
    """[..., T, 400] raw sample frames -> [..., T, 40] log-mel features."""
    hamming, dft, mel = (jnp.asarray(c) for c in _constants())
    x = frames - jnp.mean(frames, axis=-1, keepdims=True)
    prev = jnp.concatenate([x[..., :1], x[..., :-1]], axis=-1)
    x = (x - PREEMPH_COEFF * prev) * hamming
    hi = jax.lax.Precision.HIGHEST
    spec = jnp.dot(x, dft, precision=hi, preferred_element_type=jnp.float32)
    re, im = jnp.split(spec, 2, axis=-1)
    power = re * re + im * im
    energies = jnp.dot(power, mel, precision=hi,
                       preferred_element_type=jnp.float32)
    return jnp.log(jnp.maximum(energies, FLT_EPSILON))


def fbank_from_wave(wave: jnp.ndarray, n_frames: int) -> jnp.ndarray:
    """[S] -> [n_frames, 40]; n_frames must be static (padding-safe gather)."""
    return fbank_from_frames(frame_signal(wave, n_frames))


@functools.partial(jax.jit, static_argnums=1)
def _fbank_bucketed(wave: jnp.ndarray, n_frames: int) -> jnp.ndarray:
    return fbank_from_wave(wave, n_frames)


def _bucket(n: int, base: int = 16) -> int:
    """Round frame/sample counts up to limit jit cache entries."""
    if n <= base:
        return base
    return 1 << (n - 1).bit_length()


class Fbank:
    """Host-facing batch extractor with shape-bucketed jit cache."""

    def compute(self, wave: np.ndarray) -> np.ndarray:
        """[S] float32 samples -> [T, 40] float32 features (numpy)."""
        t = num_frames(wave.shape[0])
        if t == 0:
            return np.zeros((0, NUM_BINS), np.float32)
        t_pad = _bucket(t)
        s_pad = (t_pad - 1) * FRAME_SHIFT + FRAME_LENGTH
        padded = np.zeros(s_pad, np.float32)
        padded[:wave.shape[0]] = wave
        feats = _fbank_bucketed(jnp.asarray(padded), t_pad)
        return np.asarray(feats[:t])


class FbankStream:
    """Streaming wrapper: carries leftover samples between process() calls.

    Matches Fbank::Process exactly: each call emits every complete frame in
    the accumulated buffer and then drops FRAME_SHIFT * n_frames samples,
    keeping the 240-sample overlap for the next call.
    """

    def __init__(self, fbank: Optional[Fbank] = None):
        self._fbank = fbank or Fbank()
        self._buffer = np.zeros(0, np.float32)

    def process(self, samples: np.ndarray) -> np.ndarray:
        if samples.size:
            self._buffer = np.concatenate([self._buffer,
                                           samples.astype(np.float32)])
        t = num_frames(self._buffer.shape[0])
        if t == 0:
            return np.zeros((0, NUM_BINS), np.float32)
        feats = self._fbank.compute(self._buffer)
        self._buffer = self._buffer[FRAME_SHIFT * t:]
        return feats
