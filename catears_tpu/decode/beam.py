"""Batched frame-synchronous Viterbi beam search on device.

A dense redesign of the reference token-passing decoder (reference
src/decoder.{h,cc}).  The pointer-chasing structures become dense arrays:

  token beam (hash table + pools)  -> K fixed slots (state, lm, cost, bp)
  ProcessEmitting arc loop         -> CSR expansion: cumsum + searchsorted
                                      slot->arc mapping, batched gathers
  HashTable dedup + InsertTok      -> 3-key lax.sort + first-occurrence mask
  sampled-cutoff pruning           -> exact top-k + beam threshold
                                      (deterministic, tighter than the
                                      reference's LCG-sampled guess,
                                      src/decoder.cc:181-236)
  ProcessNonemitting worklist      -> bounded fixpoint while_loop over the
                                      whole beam's epsilon arcs
  OLabel GC pool linked lists      -> per-frame backpointer arena, streamed
                                      to the host per chunk

Arc costs match the reference relaxation (src/decoder.cc:337-377):
  cost = prev + graph_weight - am_scale * logp[tid2pdf[ilabel]] (+ delta-LM).

Everything is static-shape and vmapped over a batch of utterances, scanned
over frames in chunks.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from catears_tpu.graph.device import (
    DeviceFst,
    DeviceLm,
    compact_mask,
    lm_propagate_capped,
)

INF = jnp.float32(jnp.inf)
SENTINEL_STATE = jnp.int32(2**30)  # sorts after every real state

# Arc-table layout override, read ONCE at import: decode_chunk's trace is
# cached per (cfg, shapes), so an env change after the first trace would be
# silently ignored — a module constant makes the set-before-import contract
# explicit.
_TABLE_ROWMAJOR = os.environ.get("CATEARS_TABLE_ROWMAJOR") == "1"


@dataclass(frozen=True)
class BeamConfig:
    """Static decoder geometry (hashable: used as a jit static arg)."""

    beam_size: int = 4096  # K: max active tokens (reference default 30000)
    # Emitting-arc OVERFLOW capacity: arcs beyond each state's first-G block
    # (G = DeviceFst.group).  Total emitting candidates = K*G + expand_size,
    # so this only needs to cover the high-fanout tail of active states.
    expand_size: int = 8192
    eps_expand_size: int = 8192  # epsilon-closure expansion capacity
    # Delta-LM walk capacity: compact the word-emitting (olabel > 0) lanes
    # of an expansion into this many slots before the backoff walk, making
    # its cost proportional to words in flight rather than to expand_size.
    # 0 = walk every lane (exact, never truncates); > 0 is guarded by the
    # same overflow flag / hiwater telemetry as the CSR capacities.
    lm_expand_size: int = 0
    # EXPERIMENTAL, default off (0 = classic full-width sorts): when > 0,
    # large selections prefilter candidates by the beam threshold
    # (cost <= min + beam) and compact the survivors into this many slots
    # BEFORE the dedup/top-K sorts.  Exact (the threshold commutes with
    # dedup and top-K, and compaction preserves candidate order) and
    # loud-overflow (hiwater slot 3), but measured NEGATIVE on every
    # workload tried — word-dense graphs put survivor demand near
    # expansion width, and at small widths the compaction bookkeeping
    # exceeds what the narrower prune sort saves (ARCHITECTURE.md
    # round-4 notes).  Kept only to reproduce those measurements;
    # autosize never sets it.
    select_compact: int = 0
    # Hot/cold emit-table split (requires DeviceFst.hot_rows > 0): cold
    # tokens (state >= hot_rows) are compacted into this many lanes
    # before gathering the big emit table; hot tokens gather the small
    # emit_hot table.  Exact; truncation (more cold tokens than lanes)
    # is detected on device (overflow flag + hiwater slot 4).  Size from
    # the cold high-water mark like the CSR capacities.  0 = single
    # full-table gather.
    cold_expand_size: int = 0
    max_eps_iters: int = 6  # closure fixpoint bound
    beam: float = 16.0  # beam width (reference src/decoder.cc:56)
    am_scale: float = 0.1  # acoustic scale (reference src/ce_stt.cc:263)

    @property
    def arena_size(self) -> int:
        return (1 + self.max_eps_iters) * self.beam_size

    def arena_rows(self, dfst) -> int:
        """Arena rows actually reachable: 1 emitting block + one block per
        closure round.  A static epsilon depth shrinks the arena (and the
        zero-init + copy traffic every frame pays for it)."""
        return (1 + _closure_rounds(self, dfst)) * self.beam_size


def _closure_rounds(cfg: "BeamConfig", dfst) -> int:
    if dfst.eps_depth is not None and dfst.eps_depth <= cfg.max_eps_iters:
        return dfst.eps_depth
    return cfg.max_eps_iters


class BeamState(NamedTuple):
    """One utterance's beam; slots sorted by cost, state == -1 when empty."""

    states: jnp.ndarray  # i32 [K] HCLG state
    lm: jnp.ndarray  # i32 [K] delta-LM state (0 when unused)
    costs: jnp.ndarray  # f32 [K] +inf when empty
    bp: jnp.ndarray  # i32 [K] arena id of this token's latest record
    # Sticky expansion-overflow flag: True once any frame's CSR expansion
    # needed more candidate slots than cfg.expand_size/eps_expand_size (the
    # over-capacity arcs were dropped and the hypothesis may be wrong).
    # The reference iterates every arc and can never truncate
    # (src/decoder.cc:337-377); here capacities are static shapes, so
    # truncation is detected on device and surfaced by the runtime.
    overflow: jnp.ndarray  # bool scalar
    # Capacity high-water mark: the max slots any frame actually needed in
    # (emitting overflow CSR, epsilon CSR, delta-LM walk, select compact,
    # cold emit lanes) — read it after a decode with generous capacities
    # to size expand_size/eps_expand_size/lm_expand_size/select_compact/
    # cold_expand_size tightly for a deployment
    # (Decoder.capacity_high_water).  Slot 3 (beam-threshold survivor
    # demand) is reported even with select_compact=0; slot 4 (cold-token
    # count) even with cold_expand_size=0, so sizing either never needs
    # a prior configured run.
    hiwater: jnp.ndarray  # i32 [5]


class FrameTrace(NamedTuple):
    """Per-frame compact backpointers, resolved on device.

    For each beam slot (after the frame's epsilon closure):
      prev_slot — the slot in the PREVIOUS frame's beam this token came
                  from, or -1 at the decode root.
      words     — up to W = max_eps_iters + 1 output labels emitted on the
                  way (newest first, 0-padded).

    This replaces the reference's olabel linked lists (src/decoder.h:237-268)
    and keeps per-frame host traffic to K*(1+W) ints.
    """

    prev_slot: jnp.ndarray  # i32 [K]
    words: jnp.ndarray  # i32 [K, W]


def _select_best(cfg: BeamConfig, states, lms, costs, payloads,
                 compact: bool = False):
    """Dedup by (state, lm) keeping min cost, then exact top-K by cost.

    Returns ((states, lms, costs, *payload_columns), overflow, needed):
    the kept K slots plus the select-compact truncation flag and demand
    (always False overflow on the classic path; demand is reported
    whenever compact=True so sizing select_compact never needs a prior
    compacted run).

    When cfg.select_compact is set AND the caller opted in (compact=True —
    only valid where the caller applies the beam threshold to the selected
    beam immediately afterwards; the closure merge selections keep beam
    entries unconditionally and must not prefilter), the selection runs
    _select_compacted: dedup sort, then compact the POST-dedup survivors
    under the beam threshold before pruning — the second full-width sort
    shrinks to C2 lanes, or disappears entirely at C2 == K.
    """
    n = states.shape[0]
    # The selection returns exactly K slots, so the compacted array can
    # never usefully be narrower than the beam.
    c2 = max(cfg.select_compact, cfg.beam_size) if cfg.select_compact else 0
    if compact and 0 < c2 < n:
        return _select_compacted(cfg, c2, states, lms, costs, payloads)
    out, demand = _select_sorts(cfg, states, lms, costs, payloads,
                                report_demand=compact)
    return out, jnp.bool_(False), demand




def _select_compacted(cfg: BeamConfig, c2: int, states, lms, costs,
                      payloads):
    """Dedup sort, then compact survivors BEFORE the prune sort.

    Only candidates that (a) win their (state, lm) dedup group and
    (b) satisfy the beam threshold cost <= min + beam can reach the final
    beam — the caller applies exactly that threshold after selection, and
    min-before-dedup == min-after-dedup because dedup keeps group minima.
    So after the (unavoidable, full-width) dedup sort, the survivors are
    compacted into C2 slots in dedup-sort order and the prune runs at C2
    width instead of expansion width:

      C2 > K:  a C2-wide stable sort by cost (tie-break = dedup-sort
               position, exactly the classic prune key) then top-K.
      C2 == K: NO second sort at all — every survivor fits the beam, so
               the compaction IS the selection.  The returned beam is in
               dedup-sort (state) order rather than cost order; the beam
               contract requires only that the true min cost is present
               (callers use min(costs), not costs[0]) and that slot order
               is internally consistent with the returned backpointers.

    More survivors than C2 slots sets the overflow flag (BeamCapacityError
    at the runtime layer) — same contract as the CSR capacities, sized
    from hiwater slot 3.
    """
    k = cfg.beam_size
    n = states.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    if lms is None:
        s_states, s_costs, s_iota = jax.lax.sort(
            (states, costs, iota), num_keys=2)
        first = jnp.ones_like(s_states, jnp.bool_)
        first = first.at[1:].set(s_states[1:] != s_states[:-1])
    else:
        s_states, s_lms, s_costs, s_iota = jax.lax.sort(
            (states, lms, costs, iota), num_keys=3)
        first = jnp.ones_like(s_states, jnp.bool_)
        first = first.at[1:].set((s_states[1:] != s_states[:-1])
                                 | (s_lms[1:] != s_lms[:-1]))
    mn = jnp.min(costs)  # == min after dedup (dedup keeps group minima)
    # isfinite guards the dead-beam frame: with mn == INF the threshold
    # INF <= INF would keep every live lane.
    keep = (first & (s_states < SENTINEL_STATE) & jnp.isfinite(s_costs)
            & (s_costs <= mn + cfg.beam))
    (c_cost_b, c_iota), c_valid, total, _src = compact_mask(
        keep, [jax.lax.bitcast_convert_type(s_costs, jnp.int32), s_iota],
        c2)
    c_cost = jnp.where(c_valid,
                       jax.lax.bitcast_convert_type(c_cost_b, jnp.float32),
                       INF)
    if c2 > k:
        # Prune at C2 width: stable sort keeps compaction order
        # (== dedup-sort position) on cost ties — the classic prune key.
        top_costs, top_iota = jax.lax.sort((c_cost, c_iota), num_keys=1)
        sel_cost, sel_iota = top_costs[:k], top_iota[:k]
    else:
        sel_cost, sel_iota = c_cost, c_iota
    valid = jnp.isfinite(sel_cost)
    cols = [states] + ([] if lms is None else [lms]) + list(payloads)
    payload = jnp.stack(cols, axis=1)[jnp.where(valid, sel_iota, 0)]
    lms_out = (jnp.zeros((k,), jnp.int32) if lms is None
               else jnp.where(valid, payload[:, 1], 0))
    off = 1 if lms is None else 2
    out = (
        jnp.where(valid, payload[:, 0], -1),
        lms_out,
        jnp.where(valid, sel_cost, INF),
    ) + tuple(payload[:, off + i] for i in range(len(payloads)))
    return out, total > c2, total


def _select_sorts(cfg: BeamConfig, states, lms, costs, payloads,
                  report_demand: bool = False):
    """The classic two-sort exact dedup + top-K selection.

    Stable sort means ties keep input order, so earlier entries win —
    matching the reference's strict-improvement insert (src/decoder.cc:172).
    Returns ((states, lms, costs, *payload_columns) at the kept K slots,
    demand), where demand is the post-dedup beam-threshold survivor count
    (hiwater slot 3 sizing for select_compact) when report_demand is set,
    else 0.

    lms may be None (no delta-LM): drops a sort key AND an operand.  The
    payloads ride through the sorts as one iota operand and are recovered
    with a single packed post-sort row gather of K rows — cheaper than
    carrying extra [E] operands through every bitonic pass.

    Pruning is a SECOND stable sort by effective cost, not lax.top_k: on
    the previous accelerator top_k was the slower of the two.  Both break
    cost ties by position in the dedup-sorted array, so results are
    bit-identical; ROADMAP S2 measures both on the GPU.
    """
    k = cfg.beam_size
    n = states.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    if lms is None:
        s_states, s_costs, s_iota = jax.lax.sort(
            (states, costs, iota), num_keys=2)
        first = jnp.ones_like(s_states, jnp.bool_)
        first = first.at[1:].set(s_states[1:] != s_states[:-1])
    else:
        s_states, s_lms, s_costs, s_iota = jax.lax.sort(
            (states, lms, costs, iota), num_keys=3)
        first = jnp.ones_like(s_states, jnp.bool_)
        first = first.at[1:].set((s_states[1:] != s_states[:-1])
                                 | (s_lms[1:] != s_lms[:-1]))
    eff_cost = jnp.where(first & (s_states < SENTINEL_STATE), s_costs, INF)
    if report_demand:
        mn = jnp.min(costs)
        demand = jnp.sum((jnp.isfinite(eff_cost)
                          & (eff_cost <= mn + cfg.beam)).astype(jnp.int32))
    else:
        demand = jnp.int32(0)
    # Prune sort carries ONLY (eff_cost, original index): every other field
    # — state, lm, payloads — is recovered by a single packed row gather of
    # the kept K slots, instead of riding every bitonic pass as an operand
    # (each sort operand costs a full N x stages read+write).
    top_costs, top_iota = jax.lax.sort((eff_cost, s_iota), num_keys=1)
    top_costs, top_iota = top_costs[:k], top_iota[:k]
    valid = jnp.isfinite(top_costs)
    cols = [states] + ([] if lms is None else [lms]) + list(payloads)
    payload = jnp.stack(cols, axis=1)[top_iota]  # [K, 2+P] row gather
    lms_out = (jnp.zeros((k,), jnp.int32) if lms is None
               else jnp.where(valid, payload[:, 1], 0))
    off = 1 if lms is None else 2
    return (
        jnp.where(valid, payload[:, 0], -1),
        lms_out,
        jnp.where(valid, top_costs, INF),
    ) + tuple(payload[:, off + i] for i in range(len(payloads))), demand


class Cands(NamedTuple):
    """Slim expansion candidate bundle ([E] arrays, lm/bp only on demand).

    Every field materialized here is a full [E] HBM array that the
    downstream sorts and selects must then move, so cost carries the
    pre-folded token + graph weight and unused fields stay None.
    """

    tok: jnp.ndarray  # i32 [E] source beam slot
    valid: jnp.ndarray  # bool [E]
    cost: jnp.ndarray  # f32 [E] token cost + arc graph weight
    next_state: jnp.ndarray  # i32 [E]
    olabel: jnp.ndarray  # i32 [E]
    pdf: jnp.ndarray  # i32 [E]
    eps: Optional[jnp.ndarray]  # i32 [E] dest's packed eps meta, or None
    lm: Optional[jnp.ndarray]  # i32 [E] or None
    bp: Optional[jnp.ndarray]  # i32 [E] or None
    x0: Optional[jnp.ndarray]  # i32 [E] extra per-source payload, or None
    overflow: jnp.ndarray  # bool scalar
    needed: jnp.ndarray  # i32 scalar: arc slots this expansion wanted
    # Hot/cold emit split telemetry (emitting pass only): cold-token
    # demand and its truncation flag (hiwater slot 4).  Python scalar
    # defaults keep import device-free; they compose with jnp ops.
    cold_over: object = False
    cold_needed: object = 0


def _expand_csr(cfg: BeamConfig, table: jnp.ndarray, g: int,
                capacity: int, row_lo: jnp.ndarray, n_arcs: jnp.ndarray,
                costs: jnp.ndarray, lms: jnp.ndarray, bps: jnp.ndarray,
                x0s: jnp.ndarray, need_lm: bool, need_bp: bool,
                need_eps: bool, need_x0: bool = False) -> Cands:
    """CSR expansion over per-SOURCE spans (row_lo in grouped-row units).

    Sources are any [N]-sized set with per-source (cost, lm, bp, x0)
    payloads — the beam's tokens for the emitting/fallback passes, or a
    whole candidate array for the one-pass closure.

    Arcs are stored g per row of `table` (a layout fitted to a per-ROW
    gather cost; ROADMAP S3 re-measures it), so ownership bookkeeping and
    both row gathers run over capacity/g grouped slots:
      1. source row  [E/g, 8]  — per-source values packed per frame
      2. arc row     [E/g, g*5] — g arcs per fetched row
    Slot->source ownership is a scatter of span starts + cummax fill — no
    binary searches, no per-field gathers.  Outputs are flattened back to
    [capacity] candidates.
    """
    k = row_lo.shape[0]
    n_slots = -(-capacity // g)
    capacity = n_slots * g  # round up to a whole number of grouped rows
    span_rows = (n_arcs + (g - 1)) // g
    cum = jnp.cumsum(span_rows)
    cum_before = cum - span_rows
    # Spans whose rows land past n_slots are dropped by the ownership
    # scatter below — flag it so the runtime can report truncation instead
    # of returning a plausible-but-wrong path.  rows_needed feeds the
    # capacity high-water mark.
    rows_needed = cum[-1]
    overflow = rows_needed > n_slots
    slots = jnp.arange(k, dtype=jnp.int32)
    if k <= 2 * n_slots:
        # Beam-sized source sets: scatter span starts + cummax fill.
        owner = jnp.full((n_slots,), -1, jnp.int32).at[cum_before].max(
            jnp.where(span_rows > 0, slots, -1), mode="drop")
        tok = jax.lax.cummax(owner)
    else:
        # Candidate-sized source sets (one-pass closure: k >> n_slots):
        # instead of a k-element scatter, ownership is the CSR rank —
        # n_slots binary searches over the cumsum.
        s_ids = jnp.arange(n_slots, dtype=jnp.int32)
        tok = jnp.searchsorted(cum, s_ids, side="right").astype(jnp.int32)
        tok = jnp.where(s_ids < rows_needed, tok, -1)
    tok_c = jnp.clip(tok, 0, k - 1)

    # Per-source row: (row_base, arc_limit, cost_bits, lm, bp, x0, pad, pad)
    # A grouped slot s owned by source t reads arc row row_base[t] + s and
    # its candidate j is valid iff g*s + j < arc_limit[t].
    token_row = jnp.stack([
        row_lo - cum_before,
        n_arcs + g * cum_before,
        jax.lax.bitcast_convert_type(costs, jnp.int32),
        lms,
        bps,
        x0s,
        slots, slots,
    ], axis=1)  # [K, 8]
    tr = token_row[tok_c]  # [E/g, 8] row gather (small per-frame table)
    s = jnp.arange(n_slots, dtype=jnp.int32)
    row_idx = jnp.clip(tr[:, 0] + s, 0, table.shape[0] - 1)
    L = 5  # arc lanes (DeviceFst.ARC_LANES)
    ap = table[row_idx].reshape(n_slots, g, L)  # [E/g, g*5] row gather

    lanes = jnp.arange(g, dtype=jnp.int32)
    valid_e = (tok[:, None] >= 0) & (g * s[:, None] + lanes < tr[:, 1:2])

    rep = lambda x: jnp.repeat(x, g, total_repeat_length=capacity)  # noqa: E731
    tok_cost = jax.lax.bitcast_convert_type(tr[:, 2], jnp.float32)
    weight = jax.lax.bitcast_convert_type(ap[:, :, 2], jnp.float32)
    cost = (tok_cost[:, None] + weight).reshape(capacity)
    return Cands(
        tok=rep(tok_c),
        valid=valid_e.reshape(capacity),
        cost=cost,
        next_state=ap[:, :, 0].reshape(capacity),
        olabel=ap[:, :, 1].reshape(capacity),
        pdf=ap[:, :, 3].reshape(capacity),
        eps=ap[:, :, 4].reshape(capacity) if need_eps else None,
        lm=rep(tr[:, 3]) if need_lm else None,
        bp=rep(tr[:, 4]) if need_bp else None,
        x0=rep(tr[:, 5]) if need_x0 else None,
        overflow=overflow,
        needed=(rows_needed * g).astype(jnp.int32),
    )


def _expand_eps_carried(cfg: BeamConfig, dfst: DeviceFst, beam: BeamState,
                        capacity: int, eps_meta: jnp.ndarray, need_lm: bool,
                        need_eps: bool) -> Cands:
    """Epsilon expansion using CARRIED per-slot packed eps metadata.

    The metadata (eps_row_lo << 9 | n_eps) was pre-joined into the arcs
    that produced this beam (DeviceFst layout), so no state_packed gather
    is needed — the closure touches only the small eps_packed table.
    """
    eps_lo = eps_meta >> 9
    n = jnp.where(beam.states >= 0, eps_meta & 511, 0)
    return _expand_csr(cfg, dfst.eps_packed, dfst.eps_group, capacity,
                       eps_lo, n, beam.costs, beam.lm, beam.bp, beam.bp,
                       need_lm, True, need_eps)


def _expand(cfg: BeamConfig, dfst: DeviceFst, beam: BeamState, capacity: int,
            emitting: bool, need_lm: bool, need_bp: bool,
            need_eps: bool = False) -> Cands:
    """Expand the beam's arcs into a Cands bundle.

    Emitting arcs use a three-pass scheme:
      Pass S (self-loop): the extracted self-loop lanes ride the block row
        gather — one candidate per token, next state == own state.
        Self-loops are ~half of HCLG's emitting arcs, so pulling them out
        of the block halves the fanout the other passes must cover.
      Pass A (block): every token directly gathers its state's first G
        remaining arcs — K row gathers, no ownership bookkeeping,
        guaranteed coverage for the typical small-fanout HCLG state.
      Pass B (overflow): arcs beyond the first G flow through the CSR
        expansion with `capacity` candidate slots — only high-fanout states
        contribute (small over_packed table).
    The non-emitting variant (epsilon arcs via a state_packed gather) is
    the fallback for beams with no carried epsilon metadata (init, dynamic
    closure); steady-state frames use _expand_eps_carried instead.
    """
    k = cfg.beam_size
    g = dfst.group
    L = 5  # arc lanes
    state_c = jnp.clip(beam.states, 0, dfst.num_states - 1)
    valid_tok = beam.states >= 0
    if not emitting:
        sp = dfst.state_packed[state_c]  # [K, 4] row gather
        n_eps = jnp.where(valid_tok, sp[:, 1], 0)
        return _expand_csr(cfg, dfst.eps_packed, dfst.eps_group, capacity,
                           sp[:, 0], n_eps, beam.costs, beam.lm, beam.bp,
                           beam.bp, need_lm, need_bp, need_eps)

    # Passes S+A: ONE direct row gather carrying the block arcs, the
    # state_packed lanes and the extracted self-loop, token fields
    # broadcast straight from the beam arrays (no token-row indirection).
    cold_over = False
    cold_needed = 0
    if dfst.emit_compact:
        # Compact 9-lane row (graph/device.py layout docstring): half
        # the row bytes of the frame's largest gather; lane unpacking is
        # a handful of shifts/masks.
        eb = dfst.emit_block[state_c]  # [K, 9] row gather
        srl = jax.lax.shift_right_logical
        blk_next = jnp.stack([eb[:, 0] & 0xFFFFF, eb[:, 2] & 0xFFFFF], 1)
        blk_pdf = jnp.stack([srl(eb[:, 0], 20), srl(eb[:, 2], 20)], 1)
        blk_wbits = jnp.stack([eb[:, 1], eb[:, 3]], 1)
        blk_ol = jnp.stack([eb[:, 4] & 0xFFFF, srl(eb[:, 4], 16)], 1)
        blk_l4 = jnp.stack([eb[:, 5] & 0xFFFF, srl(eb[:, 5], 16)], 1)
        self_has = srl(eb[:, 7], 12) & 1
        self_ol = jnp.zeros_like(state_c)  # packable guarantees 0
        self_wbits = eb[:, 6]
        self_pdf = eb[:, 7] & 0xFFF
        n_emit_raw = srl(eb[:, 7], 13) & 0x3FF
        over_lo = eb[:, 8]
        eps_meta_self = jnp.zeros_like(state_c)  # compact => eps_removed
    else:
        if dfst.hot_rows and cfg.cold_expand_size > 0:
            # Hot/cold split (EXPERIMENTAL, off by default: peak-frame
            # cold demand reached 70% of the beam on the headline
            # workload, so the static cold capacity erases the small-
            # table win; ROADMAP D2).  Exact, loud truncation via hiwater
            # slot 4.
            cap = min(cfg.cold_expand_size, k)
            is_hot = state_c < dfst.hot_rows
            eb = dfst.emit_hot[jnp.where(is_hot, state_c, 0)]
            cold_mask = valid_tok & ~is_hot
            cold_needed = jnp.sum(cold_mask.astype(jnp.int32))
            (cold_states,), cold_ok, _total, lane = compact_mask(
                cold_mask, [state_c], cap)
            rows = dfst.emit_block[jnp.where(cold_ok, cold_states, 0)]
            lane = jnp.where(cold_ok, lane, k)  # invalid lanes drop
            eb = eb.at[lane].set(rows, mode="drop")
            cold_over = cold_needed > cap
        else:
            eb = dfst.emit_block[state_c]  # [K, G*6 + 8] row gather
        sp = eb[:, g * L:g * L + 4]
        sf = eb[:, g * L + 4:]
        blk = eb[:, :g * L].reshape(k, g, L)
        blk_next = blk[:, :, 0]
        blk_ol = blk[:, :, 1]
        blk_wbits = blk[:, :, 2]
        blk_pdf = blk[:, :, 3]
        blk_l4 = blk[:, :, 4]
        self_has = sf[:, 0]
        self_ol = sf[:, 1]
        self_wbits = sf[:, 2]
        self_pdf = sf[:, 3]
        n_emit_raw = sp[:, 3]
        over_lo = sp[:, 2]
        eps_meta_self = (jnp.zeros_like(state_c) if dfst.eps_removed
                         else (sp[:, 0] << 9) | sp[:, 1])
    n_emit = jnp.where(valid_tok, n_emit_raw, 0)
    lanes = jnp.arange(g, dtype=jnp.int32)
    valid_a = lanes[None, :] < n_emit[:, None]
    slots = jnp.arange(k, dtype=jnp.int32)
    repk = lambda x: jnp.repeat(x, g, total_repeat_length=k * g)  # noqa: E731
    blk_w = jax.lax.bitcast_convert_type(blk_wbits, jnp.float32)
    self_w = jax.lax.bitcast_convert_type(self_wbits, jnp.float32)
    cat2 = lambda a, b: jnp.concatenate([a, b])  # noqa: E731
    pass_sa = Cands(
        tok=cat2(slots, repk(slots)),
        valid=cat2(valid_tok & (self_has > 0), valid_a.reshape(k * g)),
        cost=cat2(beam.costs + self_w,
                  (beam.costs[:, None] + blk_w).reshape(k * g)),
        next_state=cat2(state_c, blk_next.reshape(k * g)),
        olabel=cat2(self_ol, blk_ol.reshape(k * g)),
        pdf=cat2(self_pdf, blk_pdf.reshape(k * g)),
        # Self-loop dest == own state: its eps metadata is the state
        # lanes; in eps_removed mode lane 4 is the composed olabel2, and
        # a true self-loop never has one.
        eps=(cat2(eps_meta_self, blk_l4.reshape(k * g))
             if need_eps else None),
        lm=(cat2(beam.lm, repk(beam.lm)) if need_lm else None),
        bp=(cat2(beam.bp, repk(beam.bp)) if need_bp else None),
        x0=None,
        overflow=jnp.bool_(False),
        needed=jnp.int32(0),
        cold_over=cold_over,
        cold_needed=cold_needed,
    )
    # Pass B: CSR overflow for states with fanout > G.  Statically skipped
    # when the whole graph's fanout fits the first-G block — the overflow
    # slots would be permanently empty and only pad the dedup sorts.
    if dfst.max_emit_fanout <= g:
        return pass_sa
    pass_b = _expand_csr(cfg, dfst.over_packed, dfst.csr_group, capacity,
                         over_lo, jnp.maximum(n_emit - g, 0), beam.costs,
                         beam.lm, beam.bp, beam.bp, need_lm, need_bp,
                         need_eps)
    cat = lambda a, b: (jnp.concatenate([a, b])  # noqa: E731
                        if a is not None else None)
    return Cands(
        tok=cat(pass_sa.tok, pass_b.tok),
        valid=cat(pass_sa.valid, pass_b.valid),
        cost=cat(pass_sa.cost, pass_b.cost),
        next_state=cat(pass_sa.next_state, pass_b.next_state),
        olabel=cat(pass_sa.olabel, pass_b.olabel),
        pdf=cat(pass_sa.pdf, pass_b.pdf),
        eps=cat(pass_sa.eps, pass_b.eps),
        lm=cat(pass_sa.lm, pass_b.lm),
        bp=cat(pass_sa.bp, pass_b.bp),
        x0=None,
        overflow=pass_b.overflow,
        needed=pass_b.needed,
        cold_over=pass_sa.cold_over,
        cold_needed=pass_sa.cold_needed,
    )


def _lm(cfg: BeamConfig, dlm: DeviceLm, lm: jnp.ndarray,
        olabel: jnp.ndarray, valid: jnp.ndarray):
    """Capped delta-LM walk + (overflow, needed) for the beam telemetry.

    Invalid expansion lanes carry garbage table reads for olabel — mask
    them out so they neither walk nor count against lm_expand_size.
    """
    ns, w, needed = lm_propagate_capped(dlm, lm,
                                        jnp.where(valid, olabel, 0),
                                        cfg.lm_expand_size)
    over = (needed > cfg.lm_expand_size if cfg.lm_expand_size > 0
            else jnp.bool_(False))
    return ns, w, over, needed


def _acoustic_lookup(logp: jnp.ndarray, pdf: jnp.ndarray) -> jnp.ndarray:
    """Exact logp[pdf] without an element gather: two-level one-hot select.

    Select the 128-wide block containing each pdf with a one-hot matmul,
    then pick the lane with a mask+reduce.  With HIGHEST precision (true
    f32, no TF32 rounding) the one-hot matmul is BIT-EXACT (1.0 x value +
    exact zeros), which chip_smoke.py checks on the card against a plain
    gather.  The form was chosen because the previous accelerator's
    element gathers were slow; ROADMAP S4 times the plain `logp[pdf]`
    gather against it on the GPU.
    """
    p = logp.shape[0]
    blocks = -(-p // 128)
    lp = jnp.pad(logp, (0, blocks * 128 - p)).reshape(blocks, 128)
    hi = pdf >> 7
    lo = pdf & 127
    oh = (hi[:, None] == jnp.arange(blocks, dtype=jnp.int32)
          ).astype(jnp.float32)  # [E, blocks]
    mid = jax.lax.dot(oh, lp,
                      precision=jax.lax.Precision.HIGHEST)  # [E, 128]
    sel = lo[:, None] == jnp.arange(128, dtype=jnp.int32)
    return jnp.sum(jnp.where(sel, mid, 0.0), axis=-1)


def _emitting_step(cfg: BeamConfig, dfst: DeviceFst, dlm: Optional[DeviceLm],
                   beam: BeamState, logp: jnp.ndarray):
    """Relax all emitting arcs; returns deduped/pruned beam + bp block 0.

    logp is this utterance's [P] log-prob row; the acoustic lookup is a
    two-level one-hot select (see _acoustic_lookup).
    """
    need_eps = (dfst.eps_depth is not None
                and 0 < dfst.eps_depth <= cfg.max_eps_iters
                and dfst.eps_meta_ok)
    c = _expand(cfg, dfst, beam, cfg.expand_size, True,
                need_lm=dlm is not None, need_bp=False, need_eps=need_eps)
    ac_cost = -cfg.am_scale * _acoustic_lookup(logp, c.pdf)
    cost = c.cost + ac_cost
    lm_over = jnp.bool_(False)
    lm_needed = jnp.int32(0)
    if dlm is not None:
        lm_state, lm_w, lm_over, lm_needed = _lm(cfg, dlm, c.lm,
                                                 c.olabel, c.valid)
        cost = cost + lm_w
    else:
        lm_state = None
    cand_state = jnp.where(c.valid, c.next_state, SENTINEL_STATE)
    cand_cost = jnp.where(c.valid, cost, INF)
    payloads = [c.tok, c.olabel] + ([c.eps] if need_eps else [])
    (states, lms, costs, parent, olab, *eps_info), sel_over, sel_needed = \
        _select_best(cfg, cand_state, lm_state, cand_cost, payloads,
                     compact=True)
    # Beam threshold: exact equivalent of the adaptive cutoff.  min, not
    # costs[0]: the compacted selection returns the beam in dedup-sort
    # order, so slot 0 need not hold the cheapest token.
    cutoff = jnp.min(costs) + cfg.beam
    keep = costs <= cutoff
    states = jnp.where(keep, states, -1)
    costs = jnp.where(keep, costs, INF)
    k = cfg.beam_size
    new_beam = BeamState(states, lms, costs,
                         jnp.arange(k, dtype=jnp.int32),
                         beam.overflow | c.overflow | lm_over | sel_over
                         | c.cold_over,
                         beam.hiwater.at[0].max(c.needed)
                         .at[2].max(lm_needed).at[3].max(sel_needed)
                         .at[4].max(c.cold_needed))
    return (new_beam, parent, jnp.where(keep, olab, 0), cutoff,
            tuple(eps_info))


def _eps_free_step(cfg: BeamConfig, dfst: DeviceFst,
                   dlm: Optional[DeviceLm], beam: BeamState,
                   logp: jnp.ndarray):
    """One-selection frame for eps-removed graphs (the production path).

    transform.remove_epsilons folded every destination's epsilon span
    into composed emitting arcs offline, so a frame is just: expand
    emitting arcs (each carrying up to TWO output labels), add acoustic
    (+ two delta-LM transitions), then ONE exact dedup + top-K + beam
    threshold.  No closure rounds, no merge selection, no trace
    composition: a whole selection pass (two multi-operand sorts) per
    frame is gone.

    Pruning semantics == OracleDecoder(one_pass_eps=True): relax the
    full closure, prune once — one step closer to the reference, whose
    closure worklist also runs before its budget pruning
    (src/decoder.cc:240-292).

    Returns (beam', prev_slot [K], words [K, 2] newest-first).
    """
    k = cfg.beam_size
    c = _expand(cfg, dfst, beam, cfg.expand_size, True,
                need_lm=dlm is not None, need_bp=False, need_eps=True)
    olab2 = c.eps  # lane 4 = composed second olabel in eps_removed mode
    cost = c.cost - cfg.am_scale * _acoustic_lookup(logp, c.pdf)
    lm_over = jnp.bool_(False)
    lm_needed = jnp.int32(0)
    if dlm is not None:
        # Two sequential LM transitions: the emitting olabel, then the
        # composed epsilon-path olabel.  mkgraph HCLGs carry words only
        # on the (removed) epsilon arcs, so the first walk is statically
        # absent for them (DeviceFst.has_emit_olabel).
        if dfst.has_emit_olabel:
            lm1, w1, over1, need1 = _lm(cfg, dlm, c.lm, c.olabel, c.valid)
            cost = cost + w1
        else:
            lm1, over1, need1 = c.lm, jnp.bool_(False), jnp.int32(0)
        lm_state, w2, over2, need2 = _lm(cfg, dlm, lm1, olab2, c.valid)
        cost = cost + w2
        lm_over = over1 | over2
        lm_needed = jnp.maximum(need1, need2)
    else:
        lm_state = None
    cand_state = jnp.where(c.valid, c.next_state, SENTINEL_STATE)
    cand_cost = jnp.where(c.valid, cost, INF)
    (states, lms, costs, tok, w0, w1_), sel_over, sel_needed = _select_best(
        cfg, cand_state, lm_state, cand_cost, [c.tok, olab2, c.olabel],
        compact=True)
    # min, not costs[0]: see _emitting_step (compacted beams are
    # state-ordered).  With compaction active every surviving slot already
    # satisfies the threshold, so keep only masks the padding lanes.
    cutoff = jnp.min(costs) + cfg.beam
    keep = costs <= cutoff
    states = jnp.where(keep, states, -1)
    costs = jnp.where(keep, costs, INF)
    new_beam = BeamState(
        states, lms, costs, jnp.arange(k, dtype=jnp.int32),
        beam.overflow | c.overflow | lm_over | sel_over | c.cold_over,
        beam.hiwater.at[0].max(c.needed).at[2].max(lm_needed)
        .at[3].max(sel_needed).at[4].max(c.cold_needed))
    words = jnp.stack([jnp.where(keep, w0, 0), jnp.where(keep, w1_, 0)],
                      axis=1)  # [K, 2] newest-first: (eps olab, emit olab)
    return new_beam, jnp.where(keep, tok, 0), words


def _arena_from_emit(cfg: BeamConfig, dfst: DeviceFst, parent, olab):
    """Arena block 0 from the emitting step (dynamic-closure path only).

    Rows are packed (parent_enc, olabel) with parent_enc = -(prev_slot+1)
    marking a previous-frame reference."""
    k = cfg.beam_size
    arena = jnp.zeros((cfg.arena_rows(dfst), 2), jnp.int32)
    arena = arena.at[:k, 0].set(-(parent + 1))
    return arena.at[:k, 1].set(olab)


def _eps_closure(cfg: BeamConfig, dfst: DeviceFst, dlm: Optional[DeviceLm],
                 beam: BeamState, arena, cutoff):
    """Bounded epsilon closure (ProcessNonemitting equivalent).

    When the graph's epsilon depth is known statically (acyclic eps
    subgraph), exactly that many relaxation rounds are run with no
    convergence check — saving the fixpoint-confirmation pass every frame
    and skipping the closure entirely for epsilon-free graphs.
    """
    k = cfg.beam_size

    def cond(carry):
        _, _, j, changed = carry
        return changed & (j < cfg.max_eps_iters)

    def body(carry):
        beam, arena, j, _ = carry
        c = _expand(cfg, dfst, beam, cfg.eps_expand_size, False,
                    need_lm=dlm is not None, need_bp=True)
        cost = c.cost
        lm_over = jnp.bool_(False)
        lm_needed = jnp.int32(0)
        if dlm is not None:
            lm_state, lm_w, lm_over, lm_needed = _lm(cfg, dlm, c.lm,
                                                     c.olabel, c.valid)
            cost = cost + lm_w
        valid_e = c.valid & (cost <= cutoff)
        cand_state = jnp.where(valid_e, c.next_state, SENTINEL_STATE)
        cand_cost = jnp.where(valid_e, cost, INF)
        # Merge current beam with candidates.  Beam entries come first so
        # the stable sort keeps them on cost ties (strict improvement).
        # Candidate refs are offset by the arena row count to mark is_cand
        # in one payload array.
        m = arena.shape[0]
        m_states = jnp.concatenate([beam.states, cand_state])
        m_lms = (jnp.concatenate([beam.lm, lm_state])
                 if dlm is not None else None)
        m_costs = jnp.concatenate([beam.costs, cand_cost])
        m_ref = jnp.concatenate([beam.bp, c.bp + m])
        m_olab = jnp.concatenate([jnp.zeros_like(beam.bp), c.olabel])
        (states, lms, costs, ref_enc, olab), sel_over, sel_needed = \
            _select_best(cfg, m_states, m_lms, m_costs, [m_ref, m_olab])
        iscand = ref_enc >= m
        ref = jnp.where(iscand, ref_enc - m, ref_enc)
        accepted = iscand & (states >= 0)
        base = (1 + j) * k
        slot_ids = base + jnp.arange(k, dtype=jnp.int32)
        new_bp = jnp.where(accepted, slot_ids, ref)
        block = jnp.stack([jnp.where(accepted, ref, 0),
                           jnp.where(accepted, olab, 0)], axis=1)
        arena = jax.lax.dynamic_update_slice(arena, block, (base, 0))
        new_beam = BeamState(states, lms, costs, new_bp,
                             beam.overflow | c.overflow | lm_over | sel_over,
                             beam.hiwater.at[1].max(c.needed)
                             .at[2].max(lm_needed).at[3].max(sel_needed))
        return new_beam, arena, j + 1, jnp.any(accepted)

    static_depth = dfst.eps_depth
    if static_depth is not None and static_depth <= cfg.max_eps_iters:
        carry = (beam, arena, jnp.zeros((), jnp.int32), jnp.bool_(True))
        for _ in range(static_depth):
            carry = body(carry)
        beam, arena, _, _ = carry
    else:
        init = (beam, arena, jnp.zeros((), jnp.int32), jnp.bool_(True))
        beam, arena, _, _ = jax.lax.while_loop(cond, body, init)
    return beam, arena


def _eps_closure_fused(cfg: BeamConfig, dfst: DeviceFst,
                       dlm: Optional[DeviceLm], beam: BeamState,
                       parent: jnp.ndarray, olab0: jnp.ndarray,
                       eps_info: Tuple, cutoff):
    """Static-depth epsilon closure with INLINE trace composition.

    When the closure depth is known statically there is no need for the
    arena at all: each round's chains extend by exactly one hop, so the
    per-slot (prev_frame_slot, words) trace is composed in-register with
    ONE packed row gather per round — no arena zero-init, no
    dynamic_update_slice copies, no resolve walk afterwards.  The beam's
    per-slot epsilon metadata (eps_info, pre-joined into the arcs that
    produced it) means no state_packed gather either: the closure touches
    only the small eps_packed table.

    beam.bp must be the identity (slot ids), as _emitting_step returns it.
    Returns (beam', prev_slot [K], words [K, rounds+1] newest-first).
    """
    k = cfg.beam_size
    rounds = _closure_rounds(cfg, dfst)
    prev = parent
    words = olab0[:, None]
    slots = jnp.arange(k, dtype=jnp.int32)
    use_meta = dfst.eps_meta_ok
    for j in range(rounds):
        # Carry dest eps metadata only while further rounds will expand it.
        carry_eps = use_meta and j + 1 < rounds
        if use_meta:
            (eps_meta,) = eps_info
            c = _expand_eps_carried(cfg, dfst, beam, cfg.eps_expand_size,
                                    eps_meta, need_lm=dlm is not None,
                                    need_eps=carry_eps)
        else:
            # Pathological eps geometry: metadata doesn't pack into one
            # lane — fall back to the state_packed gather.
            c = _expand(cfg, dfst, beam, cfg.eps_expand_size, False,
                        need_lm=dlm is not None, need_bp=True)
        cost = c.cost
        lm_over = jnp.bool_(False)
        lm_needed = jnp.int32(0)
        if dlm is not None:
            lm_state, lm_w, lm_over, lm_needed = _lm(cfg, dlm, c.lm,
                                                     c.olabel, c.valid)
            cost = cost + lm_w
        valid_e = c.valid & (cost <= cutoff)
        cand_state = jnp.where(valid_e, c.next_state, SENTINEL_STATE)
        cand_cost = jnp.where(valid_e, cost, INF)
        m_states = jnp.concatenate([beam.states, cand_state])
        m_lms = (jnp.concatenate([beam.lm, lm_state])
                 if dlm is not None else None)
        m_costs = jnp.concatenate([beam.costs, cand_cost])
        # Refs: carried beam entries point at their own slot, candidates at
        # their source slot + k (so one payload array carries is_cand too).
        m_ref = jnp.concatenate([slots, c.bp + k])
        m_olab = jnp.concatenate([jnp.zeros_like(slots), c.olabel])
        payloads = [m_ref, m_olab]
        if carry_eps:
            payloads.append(jnp.concatenate([eps_meta, c.eps]))
        (states, lms, costs, ref_enc, olab, *eps_out), sel_over, \
            sel_needed = _select_best(cfg, m_states, m_lms, m_costs,
                                      payloads)
        eps_info = tuple(eps_out)
        iscand = ref_enc >= k
        r = jnp.clip(jnp.where(iscand, ref_enc - k, ref_enc), 0, k - 1)
        row = jnp.concatenate([prev[:, None], words], axis=1)[r]  # [K, 1+w]
        accepted = iscand & (states >= 0)
        prev = row[:, 0]
        zero = jnp.zeros((k, 1), jnp.int32)
        words = jnp.where(accepted[:, None],
                          jnp.concatenate([olab[:, None], row[:, 1:]], 1),
                          jnp.concatenate([row[:, 1:], zero], 1))
        beam = BeamState(states, lms, costs, slots,
                         beam.overflow | c.overflow | lm_over | sel_over,
                         beam.hiwater.at[1].max(c.needed)
                         .at[2].max(lm_needed).at[3].max(sel_needed))
    return beam, prev, words


def _resolve_chains(cfg: BeamConfig, dfst: DeviceFst, bp: jnp.ndarray,
                    arena) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Walk each slot's same-frame arena chain -> (prev_slot, words[K, W]).

    Chain length is bounded by 1 + closure rounds actually run, so a known
    static epsilon depth shortens the walk; one packed row gather per hop.
    """
    k = cfg.beam_size
    if dfst.eps_depth is not None:
        hops = min(dfst.eps_depth, cfg.max_eps_iters) + 1
    else:
        hops = cfg.max_eps_iters + 1
    # Trace word width == walk depth: smaller scan outputs for shallow graphs
    words = jnp.zeros((k, hops), jnp.int32)
    prev_slot = jnp.full((k,), -1, jnp.int32)
    cur = bp
    active = jnp.ones((k,), jnp.bool_)
    for h in range(hops):
        row = arena[cur]  # [K, 2] packed (parent, olabel) row gather
        p, o = row[:, 0], row[:, 1]
        words = words.at[:, h].set(jnp.where(active, o, 0))
        ended = active & (p < 0)
        prev_slot = jnp.where(ended, -p - 1, prev_slot)
        cur = jnp.where(active & (p >= 0), p, cur)
        active = active & (p >= 0)
    return prev_slot, words


def _frame_step(cfg: BeamConfig, dfst: DeviceFst, dlm: Optional[DeviceLm],
                beam: BeamState, logp: jnp.ndarray,
                frame_valid: jnp.ndarray):
    """One decode frame for one utterance; identity when frame_valid is 0.

    If the beam dies (no token survives the frame — e.g. a dead-end graph
    region), the previous beam is frozen so BestPath still returns the last
    valid partial hypothesis.  The reference's Process returns false and
    relies on the caller to stop feeding frames (src/decoder.cc:74-79);
    freezing is the safe equivalent for a batched decoder where other
    utterances in the batch continue.
    """
    if dfst.eps_removed:
        # Production path: offline epsilon removal left nothing to close —
        # the whole frame is one expansion + one selection.
        new_beam, prev_slot, words = _eps_free_step(cfg, dfst, dlm, beam,
                                                    logp)
    else:
        new_beam, parent, olab0, cutoff, eps_info = _emitting_step(
            cfg, dfst, dlm, beam, logp)
        static = (dfst.eps_depth is not None
                  and dfst.eps_depth <= cfg.max_eps_iters)
        if static:
            new_beam, prev_slot, words = _eps_closure_fused(
                cfg, dfst, dlm, new_beam, parent, olab0, eps_info, cutoff)
        else:
            arena = _arena_from_emit(cfg, dfst, parent, olab0)
            new_beam, arena = _eps_closure(cfg, dfst, dlm, new_beam, arena,
                                           cutoff)
            prev_slot, words = _resolve_chains(cfg, dfst, new_beam.bp,
                                               arena)

    # Overflow only counts on real frames (padded frames re-expand the same
    # frozen beam; their truncation is reported when a real frame hits it).
    overflow = jnp.where(frame_valid, new_beam.overflow, beam.overflow)
    died = ~jnp.isfinite(new_beam.costs[0])
    frame_valid = frame_valid & ~died
    # Identity trace for padded/dead frames: every slot chains to itself in
    # the previous frame with no output.
    k = cfg.beam_size
    slots = jnp.arange(k, dtype=jnp.int32)
    keep = lambda a, b: jnp.where(frame_valid, a, b)  # noqa: E731
    out_beam = BeamState(keep(new_beam.states, beam.states),
                         keep(new_beam.lm, beam.lm),
                         keep(new_beam.costs, beam.costs),
                         slots, overflow,
                         jnp.where(frame_valid, new_beam.hiwater,
                                   beam.hiwater))
    trace = FrameTrace(
        prev_slot=keep(prev_slot, slots),
        words=jnp.where(frame_valid, words, jnp.zeros_like(words)),
    )
    return out_beam, trace


def make_init_beam(cfg: BeamConfig, dfst: DeviceFst,
                   dlm: Optional[DeviceLm]) -> Tuple[BeamState, FrameTrace]:
    """Root token + initial epsilon closure (Decoder::Initialize)."""
    k = cfg.beam_size
    states = jnp.full((k,), -1, jnp.int32).at[0].set(dfst.start)
    lm0 = dlm.start if dlm is not None else jnp.int32(0)
    lms = jnp.zeros((k,), jnp.int32).at[0].set(lm0)
    costs = jnp.full((k,), INF).at[0].set(0.0)
    bp = jnp.arange(k, dtype=jnp.int32)
    beam = BeamState(states, lms, costs, bp, jnp.bool_(False),
                     jnp.zeros((5,), jnp.int32))
    static = (dfst.eps_depth is not None
              and dfst.eps_depth <= cfg.max_eps_iters)
    if static:
        # The root beam has no carried eps metadata: gather state_packed
        # once (init only, not in the frame loop).
        sp = dfst.state_packed[jnp.clip(states, 0, dfst.num_states - 1)]
        eps_info = ((sp[:, 0] << 9) | jnp.where(states >= 0, sp[:, 1], 0),)
        beam, _, words = _eps_closure_fused(cfg, dfst, dlm, beam, bp,
                                            jnp.zeros((k,), jnp.int32),
                                            eps_info, INF)
    else:
        # Root entries terminate the backtrace: parent slot of a
        # nonexistent previous frame.
        arena = _arena_from_emit(cfg, dfst, bp, jnp.zeros((k,), jnp.int32))
        beam, arena = _eps_closure(cfg, dfst, dlm, beam, arena, INF)
        _, words = _resolve_chains(cfg, dfst, beam.bp, arena)
    # The init pseudo-frame has no predecessor: every chain roots here.
    trace = FrameTrace(jnp.full((k,), -1, jnp.int32), words)
    beam = BeamState(beam.states, beam.lm, beam.costs,
                     jnp.arange(k, dtype=jnp.int32), beam.overflow,
                     beam.hiwater)
    return beam, trace


@functools.partial(jax.jit, static_argnums=(0, 1))
def decode_chunk(cfg: BeamConfig, has_lm: bool, dfst: DeviceFst,
                 dlm, beam: BeamState, logp: jnp.ndarray,
                 frame_valid: jnp.ndarray):
    """Scan a [C, B, P] chunk of log-prob frames through the decoder.

    beam fields are [B, K]; returns (beam', FrameTrace stacked [C, B, ...]).
    """
    if _TABLE_ROWMAJOR:
        from jax.experimental.layout import Layout, with_layout_constraint
        rm = lambda t: with_layout_constraint(  # noqa: E731
            t, Layout(tuple(range(t.ndim))))
        dfst = dataclasses.replace(
            dfst, emit_block=rm(dfst.emit_block),
            over_packed=rm(dfst.over_packed),
            eps_packed=rm(dfst.eps_packed),
            state_packed=rm(dfst.state_packed))
    dlm_ = dlm if has_lm else None
    step = jax.vmap(
        lambda b, lp, fv: _frame_step(cfg, dfst, dlm_, b, lp, fv),
        in_axes=(0, 0, 0))

    def scan_fn(b, inputs):
        lp, fv = inputs
        return step(b, lp, fv)

    return jax.lax.scan(scan_fn, beam, (logp, frame_valid))


@jax.jit
def backtrace_device(traces: FrameTrace, best_slots: jnp.ndarray):
    """On-device backtrace: [T, B, ...] traces + [B] slots -> [B, T, W] words.

    Words come out frame-indexed with newest-first order inside each frame;
    assemble the final transcript by walking frames forward and reversing
    within each frame (see hyp.assemble_words).
    """

    def one(traces_u: FrameTrace, slot0):
        def step(carry, tr):
            slot, active = carry
            w = jnp.where(active, tr.words[slot], 0)
            nxt = tr.prev_slot[slot]
            new_slot = jnp.where(active & (nxt >= 0), nxt, slot)
            return (new_slot, active & (nxt >= 0)), w

        slot0 = jnp.maximum(slot0, 0)
        _, ws = jax.lax.scan(step, (slot0, jnp.bool_(True)), traces_u,
                             reverse=True)
        return ws

    return jax.vmap(one, in_axes=(1, 0))(traces, best_slots)


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def init_beam_batch(cfg: BeamConfig, has_lm: bool, batch: int,
                    dfst: DeviceFst, dlm):
    """[B]-batched initial beam + init trace."""
    dlm_ = dlm if has_lm else None
    beam, trace = make_init_beam(cfg, dfst, dlm_)
    tile = lambda x: jnp.broadcast_to(x, (batch,) + x.shape)  # noqa: E731
    return (BeamState(*(tile(x) for x in beam)),
            FrameTrace(*(tile(x) for x in trace)))
