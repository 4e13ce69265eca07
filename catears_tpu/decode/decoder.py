"""Streaming/batch decoder runtime around the device beam search.

`Decoder` mirrors the reference Decoder lifecycle (Initialize / Process /
EndOfStream / BestPath, reference src/decoder.h:76-89) for one utterance,
buffering log-prob frames into fixed-size device chunks.  `decode_batch`
decodes a whole [B, T, P] batch of utterances in one scan for throughput.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from catears_tpu.decode.beam import (
    BeamConfig,
    BeamState,
    decode_chunk,
    init_beam_batch,
)
from catears_tpu.decode.hyp import (
    HostTrace,
    IncrementalBacktracker,
    best_path,
)
from catears_tpu.decode.oracle import Hypothesis
from catears_tpu.graph.device import DeviceFst, DeviceLm, expansion_bounds
from catears_tpu.graph.fst import DeltaLmFst, FlatFst
from catears_tpu.graph.transform import prepare_decode_graph
from catears_tpu.utils import log
from catears_tpu.utils.errors import BeamCapacityError


def safe_config(fst: FlatFst, arc_group: int, base: BeamConfig,
                has_lm: bool, csr_group: int = None,
                lm_dup_factor: int = 4) -> BeamConfig:
    """Raise base's expansion capacities to the graph's worst case.

    Without a delta-LM the bound is exact and the decoder can NEVER
    truncate — the static analogue of the reference iterating every arc
    (src/decoder.cc:337-377).  For measured (rather than worst-case)
    geometry, see `autosize`.

    With a delta-LM the beam dedups on (state, lm) pairs, so the true
    worst case is K tokens all parked on the single highest-fanout state
    — K * max_rows, astronomically conservative for any real decode (at a
    50k vocab it would allocate gigabytes).  Auto capacity instead
    allows `lm_dup_factor` beam copies per HCLG state (capped at the true
    worst case); genuine overshoot is still caught by the device overflow
    flag and raises BeamCapacityError with the measured high-water mark,
    so results are never silently wrong.  `autosize` replaces this guess
    with measured demand when representative audio is available.
    """

    eb, epsb = expansion_bounds(fst, arc_group, base.beam_size,
                                distinct_states=True, csr_group=csr_group)
    if has_lm:
        eb_w, epsb_w = expansion_bounds(fst, arc_group, base.beam_size,
                                        distinct_states=False,
                                        csr_group=csr_group)
        eb = min(eb_w, lm_dup_factor * eb)
        epsb = min(epsb_w, lm_dup_factor * epsb)
    return dataclasses.replace(
        base,
        expand_size=max(base.expand_size, eb, arc_group),
        eps_expand_size=max(base.eps_expand_size, epsb, arc_group))


def _round_up(v: int, quantum: int) -> int:
    return -(-v // quantum) * quantum


def autosize(fst: FlatFst, tid2pdf: np.ndarray, logp: np.ndarray,
             am_scale: float = 0.1,
             delta_lm: Optional[DeltaLmFst] = None,
             base: Optional[BeamConfig] = None,
             margin: float = 1.25,
             arc_group: int = 4,
             csr_group: int = None) -> BeamConfig:
    """One-call deployment geometry from a representative decode.

    Runs `logp` ([T, P] or [B, T, P] log-prob frames — the harder and
    more representative, the better) through a decode with GENEROUS
    capacities (safe_config bounds, uncapped delta-LM walk), reads the
    capacity high-water telemetry, and returns a tight BeamConfig with
    `margin` headroom.  Replaces the hand-loop of reading
    Decoder.capacity_high_water and exporting env vars: geometry
    selection without tuning, the deployment property the reference gets
    by iterating every arc (reference src/decoder.cc:337-377).

    Genuine overshoot at decode time is still caught by the device
    overflow flag (BeamCapacityError), so a tight config is never
    silently wrong.  select_compact is always left 0: the knob measured
    negative on every workload tried (see ARCHITECTURE.md round-4 notes
    and the BeamConfig docstring) — set it manually only to reproduce
    those experiments.
    """
    base = base or BeamConfig(am_scale=am_scale)
    if base.am_scale != am_scale:
        base = dataclasses.replace(base, am_scale=am_scale)
    sizing = dataclasses.replace(
        safe_config(fst, arc_group, base, delta_lm is not None,
                    csr_group=csr_group, lm_dup_factor=8),
        lm_expand_size=0, select_compact=0)
    lp = np.asarray(logp, np.float32)
    if lp.ndim == 2:
        lp = lp[None]
    hw = np.zeros(5, np.int64)
    for row in lp:
        dec = Decoder(fst, tid2pdf, am_scale=am_scale, delta_lm=delta_lm,
                      config=sizing, arc_group=arc_group,
                      csr_group=csr_group)
        dec.process(row)
        dec.end_of_stream()
        dec.check_capacity()
        hw = np.maximum(hw, dec.capacity_high_water)
    g = csr_group or arc_group
    tight = dataclasses.replace(
        base,
        expand_size=max(_round_up(int(hw[0] * margin), 512), g),
        eps_expand_size=max(_round_up(int(hw[1] * margin), 512), g)
        if hw[1] else base.eps_expand_size,
        lm_expand_size=(_round_up(int(hw[2] * margin), 128)
                        if delta_lm is not None and hw[2] else 0),
    )
    return tight


def _traces_to_host(trace, num_valid: int, utt: int) -> List[HostTrace]:
    """Slice a stacked [C, B, ...] FrameTrace to per-frame host traces."""
    prev = np.asarray(trace.prev_slot[:, utt])
    words = np.asarray(trace.words[:, utt])
    return [HostTrace(prev[f], words[f]) for f in range(num_valid)]


class Decoder:
    """Single-utterance streaming decoder (reference Decoder parity API)."""

    def __init__(self, fst: FlatFst, tid2pdf: np.ndarray,
                 am_scale: float = 0.1,
                 delta_lm: Optional[DeltaLmFst] = None,
                 config: Optional[BeamConfig] = None,
                 chunk_frames: int = 20,
                 arc_group: int = 4,
                 close_eps: bool = True,
                 csr_group: int = None,
                 dfst: Optional[DeviceFst] = None,
                 dlm: Optional[DeviceLm] = None):
        auto_capacity = config is None
        if config is None:
            config = BeamConfig(am_scale=am_scale)
        elif config.am_scale != am_scale:
            config = BeamConfig(**{**config.__dict__, "am_scale": am_scale})
        if dfst is not None:
            # Adopt a prebuilt device graph (the runtime caches one per
            # Recognizer so repeated utterances skip the transform+build).
            assert not auto_capacity, \
                "prebuilt dfst requires an explicit BeamConfig"
            self.dfst = dfst
        else:
            # Offline epsilon pipeline: close chains, then fold the
            # closed spans into composed emitting arcs so the frame loop
            # is eps-free (exact transforms; see
            # graph.transform.prepare_decode_graph).
            dec_fst, cap, olab2 = fst, None, None
            if close_eps:
                g2, olab2, mode = prepare_decode_graph(fst)
                if mode != "raw":
                    dec_fst, cap = g2, 1
            if auto_capacity:
                # No explicit geometry: size capacities so truncation is
                # impossible on this graph.  Explicit configs keep their
                # (smaller, faster) capacities and rely on the runtime
                # overflow flag raising BeamCapacityError.
                config = safe_config(dec_fst, arc_group, config,
                                     delta_lm is not None,
                                     csr_group=csr_group)
            self.dfst = DeviceFst.build(dec_fst, tid2pdf, group=arc_group,
                                        eps_depth_cap=cap,
                                        csr_group=csr_group,
                                        olabel2=olab2)
        self.cfg = config
        self.fst = fst
        self.delta_lm = delta_lm
        if dlm is not None:
            self.dlm = dlm
        else:
            self.dlm = (DeviceLm.build(delta_lm)
                        if delta_lm is not None else None)
        self.has_lm = delta_lm is not None
        self.chunk_frames = chunk_frames
        self.initialize()

    def initialize(self) -> None:
        beam, trace = init_beam_batch(self.cfg, self.has_lm, 1, self.dfst,
                                      self.dlm)
        self.beam = beam
        self.traces: List[HostTrace] = [
            HostTrace(np.asarray(trace.prev_slot[0]),
                      np.asarray(trace.words[0]))
        ]
        self._pending: List[np.ndarray] = []
        self.num_frames_decoded = 0
        self.is_end_of_stream = False
        # Partial-hypothesis refreshes walk only the frames since the
        # last call (see hyp.IncrementalBacktracker).
        self._tracker = IncrementalBacktracker()

    def process(self, logp: np.ndarray) -> None:
        """Queue [n, P] log-prob rows; decodes in chunk_frames batches."""
        for row in np.asarray(logp, np.float32):
            self._pending.append(row)
        self._flush(force=False)

    def end_of_stream(self) -> None:
        self._flush(force=True)
        self.is_end_of_stream = True

    def _flush(self, force: bool) -> None:
        c = self.chunk_frames
        while self._pending and (len(self._pending) >= c or force):
            n = min(len(self._pending), c)
            rows = self._pending[:n]
            self._pending = self._pending[n:]
            p = rows[0].shape[0]
            logp = np.zeros((c, 1, p), np.float32)
            logp[:n, 0] = rows
            valid = np.zeros((c, 1), bool)
            valid[:n] = True
            self.beam, trace = decode_chunk(
                self.cfg, self.has_lm, self.dfst, self.dlm, self.beam,
                jnp.asarray(logp), jnp.asarray(valid))
            self.traces.extend(_traces_to_host(trace, n, 0))
            self.num_frames_decoded += n
            log.count("frames_decoded", n)

    @property
    def overflowed(self) -> bool:
        """True if any frame's arc expansion truncated (result suspect)."""
        return bool(np.asarray(self.beam.overflow)[0])

    @property
    def capacity_high_water(self) -> tuple:
        """(emit_overflow, eps, lm_walk, select_compact, cold_emit)
        slots the decode actually needed.

        Run a representative decode with generous capacities, then size
        BeamConfig.expand_size / eps_expand_size / lm_expand_size /
        select_compact to these marks (plus margin) for a tight deployment
        geometry.
        """
        hw = np.asarray(self.beam.hiwater)[0]
        return tuple(int(x) for x in hw)

    def check_capacity(self) -> None:
        if self.overflowed:
            raise BeamCapacityError(
                f"arc expansion overflowed capacity (expand_size="
                f"{self.cfg.expand_size}, eps_expand_size="
                f"{self.cfg.eps_expand_size}) after "
                f"{self.num_frames_decoded} frames",
                hiwater=self.capacity_high_water)

    def best_path(self) -> Hypothesis:
        self.check_capacity()
        states = np.asarray(self.beam.states[0])
        lms = np.asarray(self.beam.lm[0])
        costs = np.asarray(self.beam.costs[0])
        return best_path(self.traces, states, lms, costs, self.fst,
                         self.delta_lm,
                         end_of_stream=self.is_end_of_stream,
                         tracker=self._tracker)

    # -- session checkpoint/resume (streaming state, SURVEY.md §5) ---------

    def get_state(self) -> dict:
        """Snapshot the decode session as plain numpy arrays."""
        return {
            "beam": tuple(np.asarray(x) for x in self.beam),
            "traces": [(t.prev_slot.copy(), t.words.copy())
                       for t in self.traces],
            "pending": [r.copy() for r in self._pending],
            "num_frames_decoded": self.num_frames_decoded,
            "is_end_of_stream": self.is_end_of_stream,
        }

    def set_state(self, state: dict) -> None:
        self.beam = BeamState(*(jnp.asarray(x) for x in state["beam"]))
        self.traces = [HostTrace(p, w) for p, w in state["traces"]]
        # The tracker memo indexes the restored trace list, not the old one.
        self._tracker = IncrementalBacktracker()
        self._pending = [r.copy() for r in state["pending"]]
        self.num_frames_decoded = state["num_frames_decoded"]
        self.is_end_of_stream = state["is_end_of_stream"]


class BatchDecoder:
    """Reusable batched decoder: device graph built ONCE, decode many.

    This IS the throughput path the bench measures: traces stay on device
    per chunk and the backtrace runs as a reversed device scan
    (beam.backtrace_device) — only the final [B, T, W] word array and the
    [B, K] beam come back to the host.  The reference's CLI is its bench
    path too (src/main.cc:55-77).  decode() accepts numpy OR device
    log-probs; a device [B, T, P] array (e.g. straight from a batched AM
    forward) is chunked with device slicing so nothing round-trips
    through the host.
    """

    def __init__(self, fst: FlatFst, tid2pdf: np.ndarray,
                 am_scale: float = 0.1,
                 delta_lm: Optional[DeltaLmFst] = None,
                 config: Optional[BeamConfig] = None,
                 chunk_frames: int = 50,
                 arc_group: int = 4,
                 close_eps: bool = True,
                 csr_group: int = None,
                 dfst: Optional[DeviceFst] = None):
        self.fst = fst
        self.delta_lm = delta_lm
        self.chunk_frames = chunk_frames
        dec_fst, cap, olab2 = fst, None, None
        if close_eps and dfst is None:
            g2, olab2, mode = prepare_decode_graph(fst)
            if mode != "raw":
                dec_fst, cap = g2, 1
        self.auto_capacity = config is None
        if config is None:
            config = safe_config(dec_fst, arc_group,
                                 BeamConfig(am_scale=am_scale),
                                 delta_lm is not None, csr_group=csr_group)
        elif config.am_scale != am_scale:
            config = dataclasses.replace(config, am_scale=am_scale)
        self.cfg = config
        # dfst: adopt a prebuilt device graph (bench/profilers) — `fst`
        # must then be the same (already-transformed) graph the tables
        # were built from, as its final weights drive BestPath.
        self.dfst = dfst if dfst is not None else DeviceFst.build(
            dec_fst, tid2pdf, group=arc_group, eps_depth_cap=cap,
            csr_group=csr_group, olabel2=olab2)
        self.dlm = DeviceLm.build(delta_lm) if delta_lm is not None else None
        # (emit_overflow, eps, lm_walk, select_compact, cold_emit) slots the
        # last decode needed, max over its batch (see Decoder).
        self.capacity_high_water: Optional[tuple] = None

    def decode(self, logp, lengths: Optional[Sequence[int]] = None,
               device_backtrace: bool = True,
               retry_on_overflow: bool = True,
               retry_margin: float = 1.5,
               final_fallback: bool = False) -> List[Hypothesis]:
        """Decode a [B, T, P] log-prob batch; one Hypothesis per row.

        If a frame's expansion overflows an explicit config's capacities,
        the geometry is regrown from the decode's own capacity high-water
        telemetry (x retry_margin) and the batch is re-decoded ONCE — the
        runtime analogue of the reference never truncating because it
        iterates every arc (src/decoder.cc:337-377).  Only a second
        overflow escapes as BeamCapacityError.  retry_on_overflow=False
        restores the raise-first behavior.

        final_fallback=True backtraces the cheapest token when no final
        state is reachable (the reference's PARTIAL-hypothesis selection,
        src/decoder.cc:398) instead of returning the reference's exact
        EOS behavior (an empty hypothesis, src/decoder.cc:412) — for
        workloads whose audio may end mid-word.
        """
        if self.auto_capacity:
            retry_on_overflow = False  # safe_config bounds cannot truncate
        try:
            hyps, self.capacity_high_water = _decode_batch_once(
                self.fst, self.dfst, self.dlm, logp, lengths, self.delta_lm,
                self.cfg, self.chunk_frames, device_backtrace,
                final_fallback)
            return hyps
        except BeamCapacityError as err:
            if not retry_on_overflow or err.hiwater is None:
                raise
            regrown = _regrow_config(self.cfg, err.hiwater, retry_margin)
            log.count("overflow_retries", 1)
            import sys
            print(f"# catears: capacity overflow (hiwater={err.hiwater}); "
                  f"regrowing geometry to expand={regrown.expand_size} "
                  f"eps={regrown.eps_expand_size} "
                  f"lm={regrown.lm_expand_size} and retrying once",
                  file=sys.stderr)
            hyps, self.capacity_high_water = _decode_batch_once(
                self.fst, self.dfst, self.dlm, logp, lengths, self.delta_lm,
                regrown, self.chunk_frames, device_backtrace, final_fallback)
            return hyps


def decode_batch(fst: FlatFst, tid2pdf: np.ndarray, logp: np.ndarray,
                 lengths: Optional[Sequence[int]] = None,
                 am_scale: float = 0.1,
                 delta_lm: Optional[DeltaLmFst] = None,
                 config: Optional[BeamConfig] = None,
                 chunk_frames: int = 50,
                 arc_group: int = 4,
                 close_eps: bool = True,
                 csr_group: int = None,
                 device_backtrace: bool = True,
                 retry_on_overflow: bool = True,
                 retry_margin: float = 1.5) -> List[Hypothesis]:
    """One-shot decode of a [B, T, P] batch (see BatchDecoder)."""
    return BatchDecoder(fst, tid2pdf, am_scale=am_scale, delta_lm=delta_lm,
                        config=config, chunk_frames=chunk_frames,
                        arc_group=arc_group, close_eps=close_eps,
                        csr_group=csr_group).decode(
        logp, lengths, device_backtrace=device_backtrace,
        retry_on_overflow=retry_on_overflow, retry_margin=retry_margin)


def _regrow_config(config: BeamConfig, hiwater, margin: float) -> BeamConfig:
    """New geometry from measured demand: each overflowing capacity grows
    to its high-water mark x margin (the mark is a lower bound on true
    demand once truncation happened, hence the margin)."""
    emit, eps, lm, _sel, cold = (int(x) for x in hiwater)
    grow = lambda cur, need: max(cur, _round_up(int(need * margin), 512))
    return dataclasses.replace(
        config,
        expand_size=grow(config.expand_size, emit),
        eps_expand_size=grow(config.eps_expand_size, eps),
        lm_expand_size=(grow(config.lm_expand_size, lm)
                        if config.lm_expand_size > 0 and lm else
                        config.lm_expand_size),
        cold_expand_size=(grow(config.cold_expand_size, cold)
                          if config.cold_expand_size > 0 and cold else
                          config.cold_expand_size),
        select_compact=0,  # never retry into the experimental knob
    )


def _decode_batch_once(fst: FlatFst, dfst: DeviceFst,
                       dlm: Optional[DeviceLm], logp: np.ndarray,
                       lengths: Optional[Sequence[int]],
                       delta_lm: Optional[DeltaLmFst],
                       config: BeamConfig, chunk_frames: int,
                       device_backtrace: bool,
                       final_fallback: bool = False):
    """Returns (hypotheses, capacity high-water tuple)."""
    has_lm = dlm is not None
    on_device = isinstance(logp, jnp.ndarray)
    b, t, p = logp.shape
    lengths = list(lengths) if lengths is not None else [t] * b
    beam, init_trace = init_beam_batch(config, has_lm, b, dfst, dlm)
    len_arr = np.asarray(lengths)
    log.count("frames_decoded", int(len_arr.sum()))
    if on_device:
        logp_t = jnp.transpose(logp, (1, 0, 2))  # [T, B, P], stays on device
    dev_chunks = [jax.tree.map(lambda x: x[None], init_trace)]
    all_traces: List[List[HostTrace]] = [
        [HostTrace(np.asarray(init_trace.prev_slot[u]),
                   np.asarray(init_trace.words[u]))]
        for u in range(b)
    ] if not device_backtrace else []
    for off in range(0, t, chunk_frames):
        n = min(chunk_frames, t - off)
        valid = (off + np.arange(chunk_frames))[:, None] < len_arr[None, :]
        if on_device:
            lp = logp_t[off:off + n]
            if n < chunk_frames:
                lp = jnp.concatenate(
                    [lp, jnp.zeros((chunk_frames - n, b, p), jnp.float32)])
        else:
            chunk = np.zeros((chunk_frames, b, p), np.float32)
            chunk[:n] = np.transpose(logp[:, off:off + n], (1, 0, 2))
            lp = jnp.asarray(chunk)
        beam, trace = decode_chunk(config, has_lm, dfst, dlm, beam,
                                   lp, jnp.asarray(valid))
        if device_backtrace:
            dev_chunks.append(jax.tree.map(lambda x: x[:n], trace))
        else:
            prev = np.asarray(trace.prev_slot)
            words = np.asarray(trace.words)
            for u in range(b):
                n_valid = int(np.clip(len_arr[u] - off, 0, chunk_frames))
                for f in range(n_valid):
                    all_traces[u].append(HostTrace(prev[f, u], words[f, u]))

    overflow = np.asarray(beam.overflow)
    hiwater = tuple(int(x) for x in np.asarray(beam.hiwater).max(axis=0))
    if overflow.any():
        bad = np.flatnonzero(overflow).tolist()
        raise BeamCapacityError(
            f"arc expansion overflowed capacity (expand_size="
            f"{config.expand_size}, eps_expand_size="
            f"{config.eps_expand_size}) for utterances {bad}",
            hiwater=hiwater)
    states = np.asarray(beam.states)
    lms = np.asarray(beam.lm)
    costs = np.asarray(beam.costs)
    if not device_backtrace:
        return [
            best_path(all_traces[u], states[u], lms[u], costs[u], fst,
                      delta_lm, end_of_stream=True)
            for u in range(b)
        ], hiwater
    # Exact final-weight selection on host (delta-LM finals need the
    # backoff walk, reference src/fst.cc:235-251), then ONE device
    # backtrace for the whole batch.  Identity trace rows past each
    # utterance's length chain slot->slot with no words, so ragged
    # lengths ride through the reversed scan unchanged.
    from catears_tpu.decode.beam import backtrace_device
    from catears_tpu.decode.hyp import assemble_words
    best_slots = np.zeros(b, np.int32)
    totals = np.zeros(b, np.float64)
    empty = np.zeros(b, bool)
    for u in range(b):
        total = costs[u].astype(np.float64).copy()
        valid = states[u] >= 0
        idx = np.where(valid, states[u], 0)
        total += np.where(valid, np.asarray(dfst.final)[idx], np.inf)
        if delta_lm is not None:
            for i in np.nonzero(valid & np.isfinite(total))[0]:
                total[i] += delta_lm.final(int(lms[u, i]))
        total[~valid] = np.inf
        if not np.isfinite(total).any():
            if not final_fallback:
                empty[u] = True
                continue
            # Partial-hypothesis selection (reference pre-EOS BestPath):
            # cheapest token regardless of final weight.
            total = np.where(valid, costs[u], np.inf)
        best_slots[u] = int(np.argmin(total))
        totals[u] = total[best_slots[u]]
    traces = jax.tree.map(lambda *xs: jnp.concatenate(xs), *dev_chunks)
    words = np.asarray(backtrace_device(traces, jnp.asarray(best_slots)))
    return [
        Hypothesis([], 0.0) if empty[u]
        else Hypothesis(assemble_words(words[u]), float(totals[u]))
        for u in range(b)
    ], hiwater
