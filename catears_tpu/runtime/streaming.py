"""Fused low-latency streaming session: one device dispatch per frame chunk.

The componentized streaming path (FbankStream -> AMStream -> Decoder) is
semantically exact but pays a host<->device round trip per stage per call.
This session fuses fbank + TDNN forward + beam search for a fixed F-frame
chunk into ONE jit program, carrying the AM context window and the beam entirely on device:

  step(samples_window, ctx, beam) -> (ctx', beam', trace)

Semantics are identical to the unfused path (same replicate padding, same
AM emission lag of right_context frames, same decoder) — enforced by
equivalence tests in tests/test_streaming.py.  End-of-stream and
shorter-than-one-chunk utterances flush through the host path.

Online CMVN runs INSIDE the fused program when configured: the 600-frame
sliding window is a carried device ring buffer, the windowed sum is
recomputed from the ring every chunk (so no float drift accumulates across
a long stream), and the global-stats smoothing follows the reference
formula (reference src/cmvn.cc:70-98).  The componentized float64 host
path remains for the unfused session and the end-of-stream tail.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from catears_tpu.am.model import AcousticModel
from catears_tpu.decode.beam import BeamConfig, decode_chunk, init_beam_batch
from catears_tpu.decode.hyp import (
    HostTrace,
    IncrementalBacktracker,
    best_path,
)
from catears_tpu.decode.oracle import Hypothesis
from catears_tpu.frontend.cmvn import CMVN_GLOBAL_FRAMES, CMVN_WINDOW, FEAT_DIM
from catears_tpu.frontend.fbank import (
    FRAME_LENGTH,
    FRAME_SHIFT,
    fbank_from_wave,
    num_frames,
)
from catears_tpu.graph.device import DeviceFst, DeviceLm
from catears_tpu.graph.fst import DeltaLmFst, FlatFst
from catears_tpu.utils import log


def _am_apply(nnet_def, quantized, params, log_prior, window):
    if quantized:
        from catears_tpu.am.quant import nnet_forward_quant
        return nnet_forward_quant(nnet_def, params, window) - log_prior
    from catears_tpu.am.nnet import nnet_forward
    return nnet_forward(nnet_def, params, window) - log_prior


def _device_cmvn_chunk(gsum, gcount, ring, count, feats):
    """Online CMVN over one chunk with a carried device ring buffer.

    ring [600, 40] holds the last <= 600 raw frames (zeros before they
    exist — they drop out of the sums naturally); count is total frames
    seen.  The windowed sum is base (full ring reduce, fresh each chunk)
    plus prefix sums of the incoming minus outgoing frames, matching
    OnlineCMVN.apply exactly up to f32 accumulation.
    """
    f = feats.shape[0]
    idx = (count + jnp.arange(f, dtype=jnp.int32)) % CMVN_WINDOW
    outgoing = ring[idx]  # frames leaving the window (zeros if unfilled)
    base = jnp.sum(ring, axis=0)
    win = base + jnp.cumsum(feats, 0) - jnp.cumsum(outgoing, 0)
    counts = jnp.minimum(count + 1 + jnp.arange(f, dtype=jnp.int32),
                         CMVN_WINDOW).astype(jnp.float32)
    from_global = jnp.minimum(CMVN_WINDOW - counts,
                              float(CMVN_GLOBAL_FRAMES))
    scalar = (from_global / gcount)[:, None]
    mean = (win + scalar * gsum[None, :]) / (counts[:, None]
                                             + scalar * gcount)
    ring = ring.at[idx].set(feats)
    return feats - mean, ring, count + f


def _maybe_cmvn(cmvn: bool, feats, cm):
    if not cmvn:
        return feats, cm
    gsum, gcount, ring, count = cm
    out, ring, count = _device_cmvn_chunk(gsum, gcount, ring, count, feats)
    return out, (gsum, gcount, ring, count)


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3, 4, 5, 6, 7))
def _fused_first(nnet_def, cfg: BeamConfig, has_lm: bool, quantized: bool,
                 cmvn: bool, n_frames: int, left: int, ctx_len: int,
                 params, log_prior, dfst, dlm, beam, cm, samples):
    """First chunk: fbank -> (CMVN) -> left replicate pad -> AM -> decode."""
    feats = fbank_from_wave(samples, n_frames)  # [F + R, 40]
    feats, cm = _maybe_cmvn(cmvn, feats, cm)
    window = jnp.concatenate([jnp.repeat(feats[:1], left, axis=0), feats])
    logp = _am_apply(nnet_def, quantized, params, log_prior, window)
    valid = jnp.ones((logp.shape[0], 1), bool)
    beam, trace = decode_chunk(cfg, has_lm, dfst, dlm, beam,
                               logp[:, None, :], valid)
    return window[-ctx_len:], beam, trace, cm


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3, 4, 5))
def _fused_steady(nnet_def, cfg: BeamConfig, has_lm: bool, quantized: bool,
                  cmvn: bool, n_frames: int, params, log_prior, dfst, dlm,
                  ctx, beam, cm, samples):
    """Steady chunk: fbank -> (CMVN) -> carried context -> AM -> decode."""
    feats = fbank_from_wave(samples, n_frames)  # [F, 40]
    feats, cm = _maybe_cmvn(cmvn, feats, cm)
    window = jnp.concatenate([ctx, feats])
    logp = _am_apply(nnet_def, quantized, params, log_prior, window)
    valid = jnp.ones((logp.shape[0], 1), bool)
    beam, trace = decode_chunk(cfg, has_lm, dfst, dlm, beam,
                               logp[:, None, :], valid)
    return window[-ctx.shape[0]:], beam, trace, cm


@functools.partial(jax.jit, static_argnums=(0, 1))
def _am_only(nnet_def, quantized, params, log_prior, window):
    return _am_apply(nnet_def, quantized, params, log_prior, window)


def _maybe_cmvn_batch(cmvn: bool, feats, cm, active):
    """Vmapped CMVN rings; inactive streams keep their ring/count."""
    if not cmvn:
        return feats, cm
    gsum, gcount, rings, counts = cm
    out, new_rings, new_counts = jax.vmap(
        lambda r, c, f: _device_cmvn_chunk(gsum, gcount, r, c, f)
    )(rings, counts, feats)
    keep = active[:, None, None]
    return out, (gsum, gcount,
                 jnp.where(keep, new_rings, rings),
                 jnp.where(active, new_counts, counts))


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3, 4, 5, 6, 7))
def _bfused_first(nnet_def, cfg: BeamConfig, has_lm: bool, quantized: bool,
                  cmvn: bool, n_frames: int, left: int, ctx_len: int,
                  params, log_prior, dfst, dlm, beam, cm, samples, active):
    """Batched first chunk over [B] streams gated by `active`.

    Inactive streams feed zero samples, decode identity frames
    (frame_valid=0) and keep their CMVN ring; the caller keeps their ctx.
    """
    feats = jax.vmap(lambda s: fbank_from_wave(s, n_frames))(samples)
    feats, cm = _maybe_cmvn_batch(cmvn, feats, cm, active)
    window = jnp.concatenate(
        [jnp.repeat(feats[:, :1], left, axis=1), feats], axis=1)
    logp = jax.vmap(lambda w: _am_apply(nnet_def, quantized, params,
                                        log_prior, w))(window)  # [B, F, P]
    f = logp.shape[1]
    valid = jnp.broadcast_to(active[None, :], (f, active.shape[0]))
    beam, trace = decode_chunk(cfg, has_lm, dfst, dlm, beam,
                               jnp.transpose(logp, (1, 0, 2)), valid)
    return window[:, -ctx_len:], beam, trace, cm


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3, 4, 5))
def _bfused_steady(nnet_def, cfg: BeamConfig, has_lm: bool, quantized: bool,
                   cmvn: bool, n_frames: int, params, log_prior, dfst, dlm,
                   ctx, beam, cm, samples, active):
    """Batched steady chunk with carried per-stream context windows."""
    feats = jax.vmap(lambda s: fbank_from_wave(s, n_frames))(samples)
    feats, cm = _maybe_cmvn_batch(cmvn, feats, cm, active)
    window = jnp.concatenate([ctx, feats], axis=1)
    logp = jax.vmap(lambda w: _am_apply(nnet_def, quantized, params,
                                        log_prior, w))(window)
    f = logp.shape[1]
    valid = jnp.broadcast_to(active[None, :], (f, active.shape[0]))
    beam, trace = decode_chunk(cfg, has_lm, dfst, dlm, beam,
                               jnp.transpose(logp, (1, 0, 2)), valid)
    return window[:, -ctx.shape[1]:], beam, trace, cm


class StreamingSession:
    """Device-resident streaming decode for one utterance."""

    def __init__(self, am: AcousticModel, fst: FlatFst,
                 delta_lm: Optional[DeltaLmFst], cfg: BeamConfig,
                 dfst: DeviceFst, dlm: Optional[DeviceLm],
                 chunk_frames: int = 20,
                 cmvn_stats: Optional[np.ndarray] = None):
        self.am = am
        self.fst = fst
        self.delta_lm = delta_lm
        self.cfg = cfg
        self.dfst = dfst
        self.dlm = dlm
        self.has_lm = dlm is not None
        self.f = chunk_frames
        self.l = am.left_context
        self.r = am.right_context
        self.cmvn = cmvn_stats is not None
        if self.cmvn:
            stats = np.asarray(cmvn_stats, np.float64)
            self._cm = (jnp.asarray(stats[:FEAT_DIM], jnp.float32),
                        jnp.float32(stats[FEAT_DIM]),
                        jnp.zeros((CMVN_WINDOW, FEAT_DIM), jnp.float32),
                        jnp.int32(0))
        else:
            self._cm = (jnp.zeros((FEAT_DIM,), jnp.float32),
                        jnp.float32(1.0),
                        jnp.zeros((1, FEAT_DIM), jnp.float32),
                        jnp.int32(0))
        self._samples = np.zeros(0, np.float32)
        self._consumed_frames = 0  # feats computed by fused steps
        self._ctx = None  # device [L+R, 40] after the first step
        beam, init_trace = init_beam_batch(cfg, self.has_lm, 1, dfst, dlm)
        self.beam = beam
        self._host_traces: List[HostTrace] = [
            HostTrace(np.asarray(init_trace.prev_slot[0]),
                      np.asarray(init_trace.words[0]))
        ]
        self._dev_traces = []  # stacked [F, 1, ...] chunk traces
        self.num_frames_decoded = 0
        self._flushed = False
        # Partial hypotheses walk only the frames since the last refresh
        # (the naive full walk makes a long stream O(T^2) host work).
        self._tracker = IncrementalBacktracker()

    # -- internals ---------------------------------------------------------

    def _available_frames(self) -> int:
        return num_frames(self._samples.shape[0])

    def _next_window_frames(self) -> int:
        return self.f + self.r if self._ctx is None else self.f

    def _run_step(self) -> None:
        n_frames = self._next_window_frames()
        start = self._consumed_frames * FRAME_SHIFT
        end = start + FRAME_LENGTH + FRAME_SHIFT * (n_frames - 1)
        samples = jnp.asarray(self._samples[start:end])
        ctx_len = self.l + self.r
        if self._ctx is None:
            self._ctx, self.beam, trace, self._cm = _fused_first(
                self.am.nnet_def, self.cfg, self.has_lm, self.am.quantized,
                self.cmvn, n_frames, self.l, ctx_len, self.am.params,
                self.am.log_prior, self.dfst, self.dlm, self.beam, self._cm,
                samples)
        else:
            self._ctx, self.beam, trace, self._cm = _fused_steady(
                self.am.nnet_def, self.cfg, self.has_lm, self.am.quantized,
                self.cmvn, n_frames, self.am.params, self.am.log_prior,
                self.dfst, self.dlm, self._ctx, self.beam, self._cm, samples)
        self._consumed_frames += n_frames
        self.num_frames_decoded += self.f
        log.count("frames_decoded", self.f)
        self._dev_traces.append((trace, self.f))

    def process(self, samples: np.ndarray) -> None:
        if self._flushed:
            return
        if samples.size:
            self._samples = np.concatenate(
                [self._samples, samples.astype(np.float32)])
        while (self._available_frames()
               >= self._consumed_frames + self._next_window_frames()):
            self._run_step()

    def _host_cmvn_tail(self, feats: np.ndarray) -> np.ndarray:
        """Continue CMVN on the host from the carried device ring state."""
        gsum = np.asarray(self._cm[0], np.float64)
        gcount = float(self._cm[1])
        ring = np.asarray(self._cm[2], np.float64)
        count = int(self._cm[3])
        out = np.empty(feats.shape, np.float32)
        base = ring.sum(axis=0)
        for i, row in enumerate(feats.astype(np.float64)):
            j = (count + i) % CMVN_WINDOW
            base = base - ring[j] + row
            ring[j] = row
            c = min(count + i + 1, CMVN_WINDOW)
            fg = min(CMVN_WINDOW - c, CMVN_GLOBAL_FRAMES)
            scalar = fg / gcount
            mean = (base + scalar * gsum) / (c + scalar * gcount)
            out[i] = row - mean
        return out

    def end_of_stream(self) -> None:
        """Flush remaining feats through the host AM path (exact padding)."""
        if self._flushed:
            return
        self._flushed = True
        total = self._available_frames()
        t_extra = total - self._consumed_frames
        if self._ctx is None:
            # Never filled one chunk: whole-utterance host path
            if total == 0:
                return
            feats = np.asarray(fbank_from_wave(jnp.asarray(self._samples),
                                               total))
            if self.cmvn:
                feats = self._host_cmvn_tail(feats)
            logp = self.am.forward(feats)
        else:
            ctx = np.asarray(self._ctx)  # [L+R, 40]
            if t_extra > 0:
                start = self._consumed_frames * FRAME_SHIFT
                feats_extra = np.asarray(fbank_from_wave(
                    jnp.asarray(self._samples[start:]), t_extra))
                if self.cmvn:
                    feats_extra = self._host_cmvn_tail(feats_extra)
                window = np.concatenate([ctx, feats_extra])
            else:
                window = ctx
            window = np.concatenate(
                [window, np.repeat(window[-1:], self.r, axis=0)])
            # AM emits len - L - R = t_extra + R rows (the held-back tail)
            logp = np.asarray(_am_only(self.am.nnet_def, self.am.quantized,
                                       self.am.params, self.am.log_prior,
                                       jnp.asarray(window, jnp.float32)))
        self._decode_host(np.asarray(logp))

    def _decode_host(self, logp: np.ndarray) -> None:
        if logp.shape[0] == 0:
            return
        f = self.f
        n = logp.shape[0]
        n_pad = -(-n // f) * f
        lp = np.zeros((n_pad, 1, logp.shape[1]), np.float32)
        lp[:n, 0] = logp
        valid = np.zeros((n_pad, 1), bool)
        valid[:n] = True
        for off in range(0, n_pad, f):
            self.beam, trace = decode_chunk(
                self.cfg, self.has_lm, self.dfst, self.dlm, self.beam,
                jnp.asarray(lp[off:off + f]), jnp.asarray(valid[off:off + f]))
            n_valid = int(valid[off:off + f].sum())
            self._dev_traces.append((trace, n_valid))
            self.num_frames_decoded += n_valid
            log.count("frames_decoded", n_valid)

    def _materialize(self) -> None:
        if not self._dev_traces:
            return
        # One batched device_get (single sync) for all pending chunks.
        pulled = jax.device_get(
            [(t.prev_slot, t.words) for t, _ in self._dev_traces])
        for (prev, words), (_, n_valid) in zip(pulled, self._dev_traces):
            self._host_traces.extend(
                HostTrace(prev[i, 0], words[i, 0]) for i in range(n_valid))
        self._dev_traces = []

    @property
    def overflowed(self) -> bool:
        """True if any frame's arc expansion truncated (result suspect)."""
        return bool(np.asarray(self.beam.overflow)[0])

    def best_path(self, end_of_stream: bool) -> Hypothesis:
        if self.overflowed:
            from catears_tpu.utils.errors import BeamCapacityError
            raise BeamCapacityError(
                f"arc expansion overflowed capacity (expand_size="
                f"{self.cfg.expand_size}, eps_expand_size="
                f"{self.cfg.eps_expand_size}) after "
                f"{self.num_frames_decoded} frames")
        self._materialize()
        states, lms, costs = jax.device_get(
            (self.beam.states[0], self.beam.lm[0], self.beam.costs[0]))
        return best_path(self._host_traces, states, lms, costs, self.fst,
                         self.delta_lm, end_of_stream=end_of_stream,
                         tracker=self._tracker)


class BatchStreamingSession:
    """N concurrent live streams decoded by ONE fused program per step.

    The batched production shape of the reference's streaming design
    center (src/ce_stt.cc:295-340): per-stream sample buffers on the
    host, a shared [B]-batched fbank+AM+decode chunk step on device, and
    per-stream partial hypotheses via per-stream incremental trackers.
    Streams may receive audio at different rates: each drain round steps
    exactly the streams that have a full chunk buffered (others decode
    identity frames under frame_valid=0 and keep their AM context and
    CMVN ring), so one slow stream never stalls the batch.

    Semantics per stream are identical to StreamingSession (equivalence
    tested in tests/test_streaming.py); end_of_stream flushes a stream's
    tail through the exact host AM path with only that stream valid.
    """

    def __init__(self, am: AcousticModel, fst: FlatFst,
                 delta_lm: Optional[DeltaLmFst], cfg: BeamConfig,
                 dfst: DeviceFst, dlm: Optional[DeviceLm],
                 n_streams: int, chunk_frames: int = 20,
                 cmvn_stats: Optional[np.ndarray] = None):
        self.am = am
        self.fst = fst
        self.delta_lm = delta_lm
        self.cfg = cfg
        self.dfst = dfst
        self.dlm = dlm
        self.has_lm = dlm is not None
        self.b = n_streams
        self.f = chunk_frames
        self.l = am.left_context
        self.r = am.right_context
        self.cmvn = cmvn_stats is not None
        if self.cmvn:
            stats = np.asarray(cmvn_stats, np.float64)
            self._cm = (jnp.asarray(stats[:FEAT_DIM], jnp.float32),
                        jnp.float32(stats[FEAT_DIM]),
                        jnp.zeros((n_streams, CMVN_WINDOW, FEAT_DIM),
                                  jnp.float32),
                        jnp.zeros((n_streams,), jnp.int32))
        else:
            self._cm = (jnp.zeros((FEAT_DIM,), jnp.float32),
                        jnp.float32(1.0),
                        jnp.zeros((n_streams, 1, FEAT_DIM), jnp.float32),
                        jnp.zeros((n_streams,), jnp.int32))
        self._samples = [np.zeros(0, np.float32) for _ in range(n_streams)]
        self._consumed = [0] * n_streams  # feats consumed by fused steps
        self._started = [False] * n_streams
        self._flushed = [False] * n_streams
        self._ctx = jnp.zeros((n_streams, self.l + self.r, FEAT_DIM),
                              jnp.float32)
        beam, init_trace = init_beam_batch(cfg, self.has_lm, n_streams,
                                           dfst, dlm)
        self.beam = beam
        self._host_traces: List[List[HostTrace]] = [
            [HostTrace(np.asarray(init_trace.prev_slot[u]),
                       np.asarray(init_trace.words[u]))]
            for u in range(n_streams)
        ]
        self._dev_traces = []  # (stacked [F, B, ...] traces, n_valid)
        self.num_frames_decoded = [0] * n_streams
        self._trackers = [IncrementalBacktracker()
                          for _ in range(n_streams)]

    # -- internals ---------------------------------------------------------

    def _avail(self, u: int) -> int:
        return num_frames(self._samples[u].shape[0])

    def _need(self, u: int) -> int:
        return self.f + (self.r if not self._started[u] else 0)

    def _ready(self, u: int) -> bool:
        return (not self._flushed[u]
                and self._avail(u) >= self._consumed[u] + self._need(u))

    def _window_samples(self, u: int, n_frames: int) -> np.ndarray:
        start = self._consumed[u] * FRAME_SHIFT
        end = start + FRAME_LENGTH + FRAME_SHIFT * (n_frames - 1)
        return self._samples[u][start:end]

    def _step_group(self, group: List[int], first: bool) -> None:
        n_frames = self.f + (self.r if first else 0)
        s_len = FRAME_LENGTH + FRAME_SHIFT * (n_frames - 1)
        samples = np.zeros((self.b, s_len), np.float32)
        active = np.zeros(self.b, bool)
        for u in group:
            samples[u] = self._window_samples(u, n_frames)
            active[u] = True
        act = jnp.asarray(active)
        if first:
            ctx_new, beam, trace, cm = _bfused_first(
                self.am.nnet_def, self.cfg, self.has_lm, self.am.quantized,
                self.cmvn, n_frames, self.l, self.l + self.r,
                self.am.params, self.am.log_prior, self.dfst, self.dlm,
                self.beam, self._cm, jnp.asarray(samples), act)
        else:
            ctx_new, beam, trace, cm = _bfused_steady(
                self.am.nnet_def, self.cfg, self.has_lm, self.am.quantized,
                self.cmvn, n_frames, self.am.params, self.am.log_prior,
                self.dfst, self.dlm, self._ctx, self.beam, self._cm,
                jnp.asarray(samples), act)
        self._ctx = jnp.where(act[:, None, None], ctx_new, self._ctx)
        self.beam = beam
        self._cm = cm
        self._dev_traces.append((trace, self.f))
        for u in group:
            self._consumed[u] += n_frames
            self._started[u] = True
            self.num_frames_decoded[u] += self.f
        log.count("frames_decoded", self.f * len(group))

    def _drain(self) -> None:
        while True:
            firsts = [u for u in range(self.b)
                      if self._ready(u) and not self._started[u]]
            if firsts:
                self._step_group(firsts, first=True)
            steadies = [u for u in range(self.b)
                        if self._ready(u) and self._started[u]]
            if steadies:
                self._step_group(steadies, first=False)
            if not firsts and not steadies:
                return

    def process(self, u: int, samples: np.ndarray) -> None:
        """Feed float samples to stream u; steps every ready stream."""
        if self._flushed[u]:
            return
        if samples.size:
            self._samples[u] = np.concatenate(
                [self._samples[u], samples.astype(np.float32)])
        self._drain()

    def process_batch(self, chunks) -> None:
        """Feed one chunk per stream (None or empty to skip one), then step.

        Appends EVERY stream's samples before draining, so simultaneous
        arrivals (a server's event-loop tick delivering audio for all live
        streams) decode as one fused [B] group step.  N separate
        ``process()`` calls would drain after each append and serialize
        the same audio into N batch-1 device steps.  Per-stream decode
        results are identical either way (group membership only controls
        the active mask; equivalence vs independent sessions is tested).
        """
        for u, s in enumerate(chunks):
            if s is None or self._flushed[u]:
                continue
            s = np.asarray(s, np.float32).ravel()
            if s.size:
                self._samples[u] = np.concatenate([self._samples[u], s])
        self._drain()

    def _host_cmvn_tail(self, u: int, feats: np.ndarray) -> np.ndarray:
        gsum = np.asarray(self._cm[0], np.float64)
        gcount = float(self._cm[1])
        ring = np.asarray(self._cm[2][u], np.float64)
        count = int(self._cm[3][u])
        out = np.empty(feats.shape, np.float32)
        base = ring.sum(axis=0)
        for i, row in enumerate(feats.astype(np.float64)):
            j = (count + i) % CMVN_WINDOW
            base = base - ring[j] + row
            ring[j] = row
            c = min(count + i + 1, CMVN_WINDOW)
            fg = min(CMVN_WINDOW - c, CMVN_GLOBAL_FRAMES)
            scalar = fg / gcount
            mean = (base + scalar * gsum) / (c + scalar * gcount)
            out[i] = row - mean
        return out

    def end_of_stream(self, u: int) -> None:
        """Flush stream u's tail through the exact host AM path."""
        if self._flushed[u]:
            return
        self._drain()
        self._flushed[u] = True
        total = self._avail(u)
        t_extra = total - self._consumed[u]
        if not self._started[u]:
            if total == 0:
                return
            feats = np.asarray(fbank_from_wave(
                jnp.asarray(self._samples[u]), total))
            if self.cmvn:
                feats = self._host_cmvn_tail(u, feats)
            logp = self.am.forward(feats)
        else:
            ctx = np.asarray(self._ctx[u])
            if t_extra > 0:
                start = self._consumed[u] * FRAME_SHIFT
                feats_extra = np.asarray(fbank_from_wave(
                    jnp.asarray(self._samples[u][start:]), t_extra))
                if self.cmvn:
                    feats_extra = self._host_cmvn_tail(u, feats_extra)
                window = np.concatenate([ctx, feats_extra])
            else:
                window = ctx
            window = np.concatenate(
                [window, np.repeat(window[-1:], self.r, axis=0)])
            logp = np.asarray(_am_only(self.am.nnet_def, self.am.quantized,
                                       self.am.params, self.am.log_prior,
                                       jnp.asarray(window, jnp.float32)))
        self._decode_host(u, np.asarray(logp))

    def _decode_host(self, u: int, logp: np.ndarray) -> None:
        if logp.shape[0] == 0:
            return
        f = self.f
        n = logp.shape[0]
        n_pad = -(-n // f) * f
        lp = np.zeros((n_pad, self.b, logp.shape[1]), np.float32)
        lp[:n, u] = logp
        valid = np.zeros((n_pad, self.b), bool)
        valid[:n, u] = True
        for off in range(0, n_pad, f):
            self.beam, trace = decode_chunk(
                self.cfg, self.has_lm, self.dfst, self.dlm, self.beam,
                jnp.asarray(lp[off:off + f]),
                jnp.asarray(valid[off:off + f]))
            n_valid = int(valid[off:off + f, u].sum())
            self._dev_traces.append((trace, f))
            self.num_frames_decoded[u] += n_valid
            log.count("frames_decoded", n_valid)

    def _materialize(self) -> None:
        if not self._dev_traces:
            return
        # One device_get for every pending chunk's (prev, words): the
        # transfers dispatch together and sync once, instead of paying a
        # full round-trip latency per array.
        pulled = jax.device_get(
            [(t.prev_slot, t.words) for t, _ in self._dev_traces])
        for (prev, words), (_, n_valid) in zip(pulled, self._dev_traces):
            for u in range(self.b):
                self._host_traces[u].extend(
                    HostTrace(prev[i, u], words[i, u])
                    for i in range(n_valid))
        self._dev_traces = []

    def overflowed(self, u: int) -> bool:
        return bool(np.asarray(self.beam.overflow)[u])

    def best_path(self, u: int, end_of_stream: bool) -> Hypothesis:
        if self.overflowed(u):
            from catears_tpu.utils.errors import BeamCapacityError
            raise BeamCapacityError(
                f"arc expansion overflowed capacity for stream {u} "
                f"(expand_size={self.cfg.expand_size})")
        self._materialize()
        states, lms, costs = jax.device_get(
            (self.beam.states[u], self.beam.lm[u], self.beam.costs[u]))
        return best_path(self._host_traces[u], states, lms, costs, self.fst,
                         self.delta_lm, end_of_stream=end_of_stream,
                         tracker=self._trackers[u])

    def partials(self) -> List[Hypothesis]:
        """Refresh EVERY stream's partial hypothesis in one device round
        trip: one trace materialization plus one whole-[B] beam pull,
        then per-stream incremental host walks.  B ``best_path()`` calls
        return the same hypotheses but pay B separate device syncs for
        slices of the same arrays: B round-trip latencies per tick, not
        one."""
        ovf, states, lms, costs = jax.device_get(
            (self.beam.overflow, self.beam.states, self.beam.lm,
             self.beam.costs))
        if ovf.any():
            from catears_tpu.utils.errors import BeamCapacityError
            raise BeamCapacityError(
                f"arc expansion overflowed capacity for streams "
                f"{np.nonzero(ovf)[0].tolist()} "
                f"(expand_size={self.cfg.expand_size})")
        self._materialize()
        return [
            best_path(self._host_traces[u], states[u], lms[u], costs[u],
                      self.fst, self.delta_lm, end_of_stream=False,
                      tracker=self._trackers[u])
            for u in range(self.b)
        ]
