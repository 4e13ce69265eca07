"""Batched (offline) decoding of .scp utterance lists.

This is the throughput path, and it IS the bench path: utterances are
loaded with the native threaded WAV loader, then the whole batch runs
fbank + AM forward as ONE vmapped device program and the beam search
consumes the [B, T, P] log-probs WITHOUT them ever visiting the host
(decode.decoder.BatchDecoder with a device array).  The reference CLI
decodes scp entries strictly one at a time (src/main.cc:55-77); batching
across utterances is what fills the device.

Ragged batches stay EXACT: features are context-padded per utterance with
a clipped index gather (replicating edge frames, the reference's
streaming padding semantics, src/am.cc:115-164), so every valid output
frame equals the per-utterance computation bit-for-bit; frames past an
utterance's length are masked in the decoder scan.

Online CMVN (config `cmvn_stats`) falls back to the per-utterance host
frontend — its sliding window is inherently sequential per utterance.
"""

from __future__ import annotations

import functools
import os
import sys
import time
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from catears_tpu.decode.decoder import BatchDecoder
from catears_tpu.frontend.cmvn import OnlineCMVN
from catears_tpu.frontend.fbank import fbank_from_wave, num_frames
from catears_tpu.io.wav import read_16k_pcm, read_scp
from catears_tpu.runtime.recognizer import Recognizer
from catears_tpu.utils import log, native


def load_waves(paths: List[str]) -> List[np.ndarray]:
    """Native threaded batch load, falling back to Python per-file reads."""
    batch = native.load_wav_batch(paths) if native.available() else None
    if batch is not None:
        return batch
    return [read_16k_pcm(p) for p in paths]


def _bucket(n: int, base: int = 4096) -> int:
    if n <= base:
        return base
    return 1 << (n - 1).bit_length()


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3, 4))
def _batched_logp_jit(nnet_def, quantized: bool, left: int, right: int,
                      t_max: int, params, log_prior, waves, frame_counts):
    """[B, S] padded waves + [B] frame counts -> [B, T_max, P] on device.

    Per-utterance replicate context padding via a clipped index gather:
    padded row j of utterance u reads feats[clip(j - left, 0, t_u - 1)],
    so output frame i < t_u sees exactly the reference's edge-replicated
    window regardless of the batch padding.
    """
    def one(w, t_u):
        feats = fbank_from_wave(w, t_max)  # [T_max, 40]
        idx = jnp.clip(jnp.arange(t_max + left + right) - left, 0, t_u - 1)
        padded = feats[idx]
        if quantized:
            from catears_tpu.am.quant import nnet_forward_quant
            return nnet_forward_quant(nnet_def, params, padded) - log_prior
        from catears_tpu.am.nnet import nnet_forward
        return nnet_forward(nnet_def, params, padded) - log_prior

    return jax.vmap(one)(waves, frame_counts)


def batched_logp(am, waves: List[np.ndarray]) -> Tuple[jnp.ndarray,
                                                       List[int]]:
    """Batch of ragged waves -> ([B, T_max, P] device log-probs, lengths)."""
    lengths = [num_frames(w.shape[0]) for w in waves]
    t_max = max(max(lengths), 1)
    s_max = _bucket(max(w.shape[0] for w in waves))
    t_bucket = num_frames(s_max)
    padded = np.zeros((len(waves), s_max), np.float32)
    for i, w in enumerate(waves):
        padded[i, :w.shape[0]] = w
    logp = _batched_logp_jit(am.nnet_def, am.quantized, am.left_context,
                             am.right_context, t_bucket, am.params,
                             am.log_prior, jnp.asarray(padded),
                             jnp.asarray(lengths, jnp.int32))
    return logp[:, :t_max], lengths


def get_batch_decoder(recognizer: Recognizer,
                      chunk_frames: int = 50) -> BatchDecoder:
    """Cached BatchDecoder for a Recognizer (device graph built once)."""
    cached = getattr(recognizer, "_batch_decoder", None)
    if cached is None or cached.chunk_frames != chunk_frames:
        cached = BatchDecoder(
            recognizer.fst, recognizer.am.tid2pdf,
            delta_lm=recognizer.delta_lm, config=recognizer.beam_config,
            chunk_frames=chunk_frames, arc_group=recognizer.arc_group,
            csr_group=recognizer.csr_group)
        recognizer._batch_decoder = cached
    return cached


def decode_scp(recognizer: Recognizer, scp_path: str, batch_size: int = 16,
               chunk_frames: int = 50) -> List[Tuple[str, str]]:
    """Decode every `name path` entry; returns (name, hyp) pairs in order.

    CATEARS_TIMING=1 prints decode-phase xRT (audio seconds per wall
    second, excluding the one-time graph build/compile) to stderr.
    """
    entries = read_scp(scp_path)
    results: List[Tuple[str, str]] = []
    cmvn = (OnlineCMVN(recognizer.cmvn_stats)
            if recognizer.cmvn_stats is not None else None)
    table = recognizer.symbol_table
    dec = get_batch_decoder(recognizer, chunk_frames)
    timing = os.environ.get("CATEARS_TIMING") == "1"
    audio_s = 0.0
    t0 = time.perf_counter()
    for lo in range(0, len(entries), batch_size):
        chunk = entries[lo:lo + batch_size]
        waves = load_waves([path for _, path in chunk])
        audio_s += sum(w.shape[0] for w in waves) / 16000.0
        if cmvn is None:
            logp, lengths = batched_logp(recognizer.am, waves)
        else:
            logps = []
            for wave in waves:
                feats = recognizer.fbank.compute(wave)
                feats = cmvn.apply(feats)
                logps.append(recognizer.am.forward(feats))
            lengths = [lp.shape[0] for lp in logps]
            t_max = max(max(lengths), 1)
            p = logps[0].shape[1]
            logp = np.zeros((len(chunk), t_max, p), np.float32)
            for i, lp in enumerate(logps):
                logp[i, :lp.shape[0]] = lp
        hyps = dec.decode(logp, lengths)
        for (name, _), hyp in zip(chunk, hyps):
            results.append((name, " ".join(table.get(w) for w in hyp.words)))
    if timing:
        dt = time.perf_counter() - t0
        print(f"# decode_scp: {audio_s:.1f} audio-s in {dt:.2f}s = "
              f"{audio_s / dt:.1f} xRT (decode phase, "
              f"{len(entries)} utts, batch {batch_size})", file=sys.stderr)
    log.count("audio_seconds", audio_s)
    return results
