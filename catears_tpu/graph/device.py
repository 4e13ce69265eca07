"""Device-resident WFST arrays and vectorized LM lookups.

The reference decoder chases pointers through OpenFST arc iterators and
resolves big-LM backoff chains one query at a time with binary searches
(reference src/fst.cc:131-154,210-233) behind a 1M-entry direct-mapped cache
(src/fst.cc:292-327).  On the device both become dense vector ops: arcs
live in CSR arrays in device memory, expansion is a batched gather, and backoff walks run as a
bounded while_loop over whole candidate vectors, making the scalar cache
unnecessary.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from catears_tpu.graph.fst import DeltaLmFst, FlatFst
from catears_tpu.utils.errors import CorruptionError

INT32_SENTINEL = np.int32(2**30)


def compact_mask(keep: jnp.ndarray, cols, c2: int):
    """Order-preserving compaction of masked lanes into C2 slots.

    Compaction without scatters or per-row gathers for the bookkeeping:
    segment the array 512 wide, sort each segment's kept-iota keys (a
    single-operand sort over rows — log^2(512) stages instead of the
    full array's log^2(N)), then place survivors by rank with vectorized
    segment arithmetic + one packed row gather of C2 rows.  Survivor
    order == input order.  Returns (compacted i32 columns, valid mask
    [C2], total survivors, src lane index [C2]); lanes past `total` read
    column 0's lane 0 — mask with `valid`.
    """
    n = keep.shape[0]
    seg = 512
    npad = -(-n // seg) * seg
    nseg = npad // seg
    iota = jnp.arange(n, dtype=jnp.int32)
    keep_p = jnp.pad(keep, (0, npad - n))
    skey = jnp.where(keep_p, jnp.pad(iota, (0, npad - n)), npad)
    sk = jax.lax.sort(skey.reshape(nseg, seg)).reshape(npad)
    counts = jnp.sum(keep_p.reshape(nseg, seg), axis=1, dtype=jnp.int32)
    ends = jnp.cumsum(counts)
    total = ends[-1]
    j = jnp.arange(c2, dtype=jnp.int32)
    # Segment of output slot j = number of segments fully used before it;
    # its start offset recovered with a one-hot select (no row gathers on
    # the tiny [nseg] tables — a compare+reduce instead).
    segj = jnp.sum((ends[None, :] <= j[:, None]).astype(jnp.int32), axis=1)
    segc = jnp.minimum(segj, nseg - 1)
    onehot = segc[:, None] == jnp.arange(nseg, dtype=jnp.int32)
    start_j = jnp.sum(jnp.where(onehot, (ends - counts)[None, :], 0),
                      axis=1)
    src = sk[jnp.clip(segc * seg + (j - start_j), 0, npad - 1)]
    valid_j = j < total
    src = jnp.where(valid_j, src, 0)  # kept skey entries are < n
    if not cols:
        return [], valid_j, total, src
    packed = jnp.stack(list(cols), axis=1)[src]  # [C2, F] row gather
    return [packed[:, i] for i in range(len(cols))], valid_j, total, src


def _lm_hash(xp, s, l, seed: int, mask: int):
    """Deterministic (state, label) bucket hash, identical under np/jnp.

    uint32 arithmetic wraps the same way in both (pass xp=np offline,
    xp=jnp on device), so the builder and the lookup agree bit-for-bit.
    """
    h = (s.astype(xp.uint32) * xp.uint32(0x9E3779B1)
         ^ l.astype(xp.uint32) * xp.uint32(0x85EBCA77)
         ^ xp.uint32(seed))
    h = h ^ (h >> 15)
    h = h * xp.uint32(0x2C1B3C6D)
    h = h ^ (h >> 13)
    return (h & xp.uint32(mask)).astype(xp.int32)


def _per_state_arc_counts(fst: FlatFst):
    """(n_eps, n_emit) int64 [S]: per-state epsilon / emitting arc counts.

    n_emit excludes each state's first emitting self-loop (extracted into
    dedicated block lanes by DeviceFst.build — see self-loop extraction)."""
    n_all = np.diff(fst.offsets.astype(np.int64))
    state_of_arc = np.repeat(np.arange(fst.num_states), n_all)
    is_eps = fst.arc_ilabel == 0
    n_eps = np.bincount(state_of_arc[is_eps],
                        minlength=fst.num_states).astype(np.int64)
    has_self = np.zeros(fst.num_states, bool)
    has_self[state_of_arc[~is_eps & (fst.arc_next == state_of_arc)]] = True
    return n_eps, n_all - n_eps - has_self.astype(np.int64)


def expansion_bounds(fst: FlatFst, group: int, beam_size: int,
                     distinct_states: bool = True,
                     csr_group: Optional[int] = None,
                     eps_group: Optional[int] = None) -> Tuple[int, int]:
    """Worst-case (expand_size, eps_expand_size) for a beam of K tokens.

    The emitting expansion's CSR overflow pass allocates ceil(max(n_emit
    - group, 0) / csr_group) rows per active token, and the epsilon
    closure ceil(n_eps / csr_group) rows; with at most K live tokens on
    distinct states, the exact worst case is the sum over the K largest
    per-state row counts.  Capacities at these bounds can NEVER truncate
    (the reference iterates all arcs and never truncates either,
    src/decoder.cc:337-377); smaller capacities are guarded by the
    runtime overflow flag in decode.beam.

    With delta-LM rescoring the beam dedups on (state, lm) pairs, so all K
    tokens can share one state — pass distinct_states=False for the
    K * max-rows bound instead of the top-K-distinct sum.
    """
    gc = csr_group or group
    ge = eps_group or group
    n_eps, n_emit = _per_state_arc_counts(fst)
    over_rows = -(-np.maximum(n_emit - group, 0) // gc)
    eps_rows = -(-n_eps // ge)

    def worst(rows: np.ndarray) -> int:
        if rows.size == 0:
            return 0
        if not distinct_states:
            return beam_size * int(rows.max())
        k = min(beam_size, rows.size)
        top = np.partition(rows, rows.size - k)[rows.size - k:]
        return int(top.sum())

    return gc * worst(over_rows), ge * worst(eps_rows)


def _eps_depth(fst: FlatFst, bound: int = 16) -> Optional[int]:
    """Longest epsilon-arc chain, or None if cyclic/deeper than bound.

    A known static depth lets the decoder run exactly that many closure
    iterations with no fixpoint check (saving one full expand+sort pass
    per frame, and the whole closure for epsilon-free graphs).
    """
    is_eps = fst.arc_ilabel == 0
    state_of_arc = np.repeat(np.arange(fst.num_states),
                             np.diff(fst.offsets))
    src = state_of_arc[is_eps]
    dst = fst.arc_next[is_eps]
    if src.size == 0:
        return 0
    # depth[s] = longest eps path starting at s; relax to fixpoint
    depth = np.zeros(fst.num_states, np.int64)
    for _ in range(bound + 1):
        new = depth.copy()
        np.maximum.at(new, src, depth[dst] + 1)
        if (new == depth).all():
            return int(depth.max())
        depth = new
    return None  # cyclic or deeper than bound


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["start", "final", "state_packed", "over_packed",
                 "eps_packed", "emit_block", "emit_hot"],
    meta_fields=["eps_depth", "group", "csr_group", "eps_group",
                 "eps_meta_ok", "max_emit_fanout", "eps_removed",
                 "has_emit_olabel", "hot_rows", "emit_compact"])
@dataclasses.dataclass(frozen=True)
class DeviceFst:
    """HCLG graph as device arrays (arcs (state, ilabel)-sorted).

    The layout was fitted to the previous accelerator's gather cost model
    (cost per ROW with width nearly free, and higher per row from large
    tables); ROADMAP S3 measures it again on the GPU.  The layout (a)
    fetches arcs
    `group` (G) at a time, (b) keeps the random-access side tables SMALL
    by splitting epsilon and overflow arcs into separate sub-tables (for
    real HCLGs both are a few MB even at 50k words — only high-fanout
    states overflow and only word-end states carry epsilons), and (c)
    PRE-JOINS each arc's destination epsilon metadata into the arc record
    so the per-frame closure never touches the [S]-sized state table:

    * SELF-LOOP EXTRACTION: every state's first emitting self-loop (the arc
      HCLG's add-self-loops puts on every HMM state — typically HALF of all
      emitting arcs) is pulled out into 4 dedicated lanes of the block row.
      A self-loop needs no next-state lane and no slot bookkeeping: the
      candidate is (same state, cost + w + acoustic), one per token.
    * `emit_block [S, G*5 + 8]` — every state's FIRST G remaining emitting
      arcs ++ the state_packed lanes ++ the extracted self-loop lanes
      (has, olabel, weight_bits, pdf).  Each active token does ONE direct
      row gather here (the only big-table gather in the frame loop).
    * `over_packed [Ro, Gc*5]` — emitting-arc OVERFLOW (non-self arcs
      beyond the first G) for high-fanout states, spans padded to row
      boundaries.  Gc = csr_group may exceed G: wide rows fetch the
      high-fanout tail in fewer gathers.
    * `eps_packed [Re, Ge*5]` — all epsilon arcs, Ge = eps_group.
    * `state_packed [S, 4]` i32: (eps_row_lo, n_eps, emit_over_lo, n_emit)
      with *_lo in rows of the respective sub-table and counts in raw
      arcs (n_emit excludes the extracted self-loop).  Only touched at
      init and on the dynamic-closure fallback path: steady-state frames
      read epsilon metadata pre-joined into the arcs.

    Each stored arc is 5 i32 lanes:
      (next, olabel, weight_bits(f32), pdf, dest_eps_meta)
    with dest_eps_meta = state_packed[next][0] << 9 | state_packed[next][1]
    (the destination's eps CSR row and arc count packed into one lane),
    letting the epsilon closure expand a freshly selected beam without
    gathering state_packed.  When a graph's epsilon geometry doesn't fit
    the packing (n_eps >= 512 or >= 2^22 eps rows — pathological for
    HCLGs), eps_meta_ok is False and the closure falls back to the
    state_packed gather.
    Padding arcs are zeros — harmless because expansion masks candidates
    beyond each span's true arc count.
    """

    start: jnp.ndarray  # i32 scalar
    final: jnp.ndarray  # f32 [S]
    state_packed: jnp.ndarray  # i32 [S, 4]
    over_packed: jnp.ndarray  # i32 [Ro, csr_group*5]
    eps_packed: jnp.ndarray  # i32 [Re, eps_group*5]
    emit_block: jnp.ndarray  # i32 [S, group*5 + 8] (arcs ++ state ++ self)
    eps_depth: Optional[int]  # static: longest eps chain, None if unbounded
    group: int  # arcs per per-token block row
    csr_group: int  # arcs per overflow CSR gather row (>= group typically)
    eps_group: int  # arcs per epsilon CSR gather row
    eps_meta_ok: bool  # static: dest eps metadata packs into one lane
    max_emit_fanout: int  # static: max non-self emitting arcs of any state
    # Static: graph came from transform.remove_epsilons — EMITTING arc
    # records carry the composed second output label (olabel2) in lane 4
    # instead of dest eps metadata, and the frame loop runs with no
    # epsilon closure at all (decode.beam._eps_free_step).  The eps
    # tables remain (epsilon arc records keep their meta) for the
    # decode-root initialization closure.
    eps_removed: bool = False
    # Static: some emitting arc carries a FIRST output label.  mkgraph
    # HCLGs put word labels on the word-end epsilon arcs, so after
    # remove_epsilons only the composed second label (lane 4) is ever
    # nonzero — the delta-LM's first-walk pass is statically skippable.
    has_emit_olabel: bool = True
    # Hot/cold emit split: rows [0, hot_rows) of emit_block are COPIED
    # into the separate emit_hot table, so the frequency-renumbered hot
    # states (graph.transform.hot_order) gather from a small table and
    # only the compacted cold lanes from the big one.  It assumed gathers
    # cost more per row from larger tables; off by default, measured
    # again on the GPU by ROADMAP S3 and then kept or deleted (D2).
    # 0 = single-table layout.  Requires BeamConfig.cold_expand_size > 0
    # to take effect in the decoder.
    emit_hot: Optional[jnp.ndarray] = None
    hot_rows: int = 0
    # Static: emit_block uses the COMPACT 9-lane row (eps-removed, G=2
    # graphs whose fields fit the packed widths — see build()).  Packing
    # the 18-lane row into 9 lanes halves the emit table (44.5 -> 22.2 MB
    # for the 618k-state trie) and the bytes of the frame's largest
    # gather; ROADMAP S3 measures the gain on the GPU.  Layout:
    #   0: next0 | pdf0 << 20        1: w0 bits (f32)
    #   2: next1 | pdf1 << 20        3: w1 bits
    #   4: olabel0 | olabel1 << 16   5: olabel2_0 | olabel2_1 << 16
    #   6: w_self bits
    #   7: self_pdf | self_has << 12 | n_emit << 13
    #   8: emit_over_lo
    emit_compact: bool = False

    ARC_LANES = 5

    @classmethod
    def build(cls, fst: FlatFst, tid2pdf: np.ndarray, group: int = 4,
              eps_depth_cap: Optional[int] = None,
              csr_group: Optional[int] = None,
              eps_group: Optional[int] = None,
              olabel2: Optional[np.ndarray] = None,
              hot_rows: int = 0,
              compact: Optional[bool] = None) -> "DeviceFst":
        """eps_depth_cap: caller-guaranteed closure round bound (e.g. 1
        after graph.transform.close_epsilons) — the syntactic chain depth
        measured here stays larger because closure keeps original arcs.
        olabel2: per-arc second output label from remove_epsilons; its
        presence switches the layout to eps_removed mode."""
        gc = csr_group or group
        ge = eps_group or group
        s = fst.num_states
        offsets = fst.offsets.astype(np.int64)
        n_all = np.diff(offsets)
        # ilabel==0 arcs prefix each (state, ilabel)-sorted span.
        state_of_arc = np.repeat(np.arange(s), n_all)
        is_eps = fst.arc_ilabel == 0
        n_eps = np.bincount(state_of_arc[is_eps],
                            minlength=s).astype(np.int64)
        n_emit = n_all - n_eps
        tid2pdf = np.asarray(tid2pdf, np.int32)
        # Fail loudly on corrupt graphs: every emitting ilabel must be a
        # valid transition-id (the reference's Status-checked loaders refuse
        # out-of-range inputs, src/fst.cc:51-111).
        bad = ~is_eps & ((fst.arc_ilabel < 0)
                         | (fst.arc_ilabel >= tid2pdf.size))
        if bad.any():
            i = int(np.argmax(bad))
            raise CorruptionError(
                f"FST arc {i} has ilabel {int(fst.arc_ilabel[i])} outside "
                f"the transition table [0, {tid2pdf.size})")
        arc_pdf = np.where(is_eps, 0,
                           tid2pdf[np.minimum(fst.arc_ilabel,
                                              tid2pdf.size - 1)]
                           ).astype(np.int32)

        # Extract each state's FIRST emitting self-loop into dedicated
        # lanes; any further self-loops stay ordinary arcs.
        is_self = ~is_eps & (fst.arc_next == state_of_arc)
        self_states, first_pos = np.unique(state_of_arc[is_self],
                                           return_index=True)
        self_idx = np.flatnonzero(is_self)[first_pos]
        extracted = np.zeros(fst.num_arcs, bool)
        extracted[self_idx] = True
        keep = ~is_eps & ~extracted  # remaining emitting arcs
        n_emit = np.bincount(state_of_arc[keep],
                             minlength=s).astype(np.int64)

        # Sub-table CSR layouts: epsilon arcs and emitting overflow (arcs
        # beyond the first-G block) each get their OWN flat table, spans
        # padded to row boundaries.  Keeping these tables small (only
        # word-end states have epsilons, only high-fanout states overflow)
        # keeps their gathers cheap.
        n_over = np.maximum(n_emit - group, 0)
        eps_rows = -(-n_eps // ge)
        over_rows = -(-n_over // gc)
        eps_row_lo = np.concatenate([[0], np.cumsum(eps_rows)])[:-1]
        emit_over_lo = np.concatenate([[0], np.cumsum(over_rows)])[:-1]
        n_eps_rows = max(int(eps_rows.sum()), 1)
        n_over_rows = max(int(over_rows.sum()), 1)

        # Pre-join destination epsilon metadata into every arc record,
        # packed into ONE lane: eps_row_lo << 9 | n_eps.
        eps_meta_ok = bool(n_eps.max(initial=0) < 512
                           and eps_rows.sum() < 2 ** 22)
        if eps_meta_ok:
            dst_meta = (eps_row_lo[fst.arc_next] << 9
                        | n_eps[fst.arc_next]).astype(np.int32)
        else:
            dst_meta = np.zeros(fst.num_arcs, np.int32)
        if olabel2 is not None:
            # eps-removed layout: emitting records carry the composed
            # second olabel; epsilon records keep closure metadata (they
            # only serve the init closure).
            lane4 = np.where(is_eps, dst_meta,
                             np.asarray(olabel2, np.int32))
        else:
            lane4 = dst_meta
        packed = np.stack([
            fst.arc_next, fst.arc_olabel,
            fst.arc_weight.view(np.int32), arc_pdf,
            lane4,
        ], axis=1).astype(np.int32)
        lanes = packed.shape[1]
        self_arc = np.zeros((s, 4), np.int32)
        self_arc[self_states, 0] = 1  # has
        self_arc[self_states, 1:] = packed[self_idx, 1:4]

        rank = np.arange(fst.num_arcs) - np.repeat(offsets[:-1], n_all)
        # rank among REMAINING emitting arcs of the state (gaps left by the
        # extracted self-loop close up)
        cum = np.cumsum(keep)  # inclusive kept-count
        before = np.concatenate([[0], cum])[offsets[:-1]]  # kept < span
        emit_rank = cum - 1 - before[state_of_arc]
        in_block = keep & (emit_rank < group)
        in_over = keep & (emit_rank >= group)
        dest_eps = eps_row_lo[state_of_arc] * ge + rank
        dest_over = emit_over_lo[state_of_arc] * gc + emit_rank - group
        eps_flat = np.zeros((n_eps_rows * ge, lanes), np.int32)
        eps_flat[dest_eps[is_eps]] = packed[is_eps]
        over_flat = np.zeros((n_over_rows * gc, lanes), np.int32)
        over_flat[dest_over[in_over]] = packed[in_over]
        block = np.zeros((s * group, lanes), np.int32)
        block[state_of_arc[in_block] * group
              + emit_rank[in_block]] = packed[in_block]

        state_packed = np.stack([
            eps_row_lo, n_eps, emit_over_lo, n_emit
        ], axis=1).astype(np.int32)
        emit_block_np = np.concatenate(
            [block.reshape(s, group * lanes), state_packed, self_arc],
            axis=1)
        # Compact 9-lane emit row (see class docstring): only for the
        # production eps-removed mode with G=2 and field widths that fit
        # the packing — guards fall back to the classic 18-lane layout.
        emit_compact = (compact is not False) and bool(
            olabel2 is not None and group == 2 and hot_rows == 0
            and s < 2 ** 20
            and arc_pdf.max(initial=0) < 4096
            and int(self_arc[:, 3].max(initial=0)) < 4096
            and fst.arc_olabel.max(initial=0) < 65536
            and (olabel2 is None or int(np.asarray(olabel2).max(initial=0))
                 < 65536)
            and int(n_emit.max(initial=0)) < 1024
            and int(self_arc[:, 1].max(initial=0)) == 0)
        if emit_compact:
            blk = block.reshape(s, group, lanes).astype(np.int64)
            sa = self_arc.astype(np.int64)
            pack = lambda v: ((v & 0xFFFFFFFF).astype(np.uint32)  # noqa: E731
                              .view(np.int32))
            emit_block_np = np.stack([
                pack(blk[:, 0, 0] | (blk[:, 0, 3] << 20)),
                pack(blk[:, 0, 2]),
                pack(blk[:, 1, 0] | (blk[:, 1, 3] << 20)),
                pack(blk[:, 1, 2]),
                pack(blk[:, 0, 1] | (blk[:, 1, 1] << 16)),
                pack(blk[:, 0, 4] | (blk[:, 1, 4] << 16)),
                pack(sa[:, 2]),
                pack(sa[:, 3] | (sa[:, 0] << 12)
                     | (n_emit.astype(np.int64) << 13)),
                emit_over_lo.astype(np.int32),
            ], axis=1)
        hot_rows = min(hot_rows, s)
        return cls(
            start=jnp.int32(fst.start),
            final=jnp.asarray(fst.final),
            state_packed=jnp.asarray(state_packed),
            over_packed=jnp.asarray(over_flat.reshape(n_over_rows,
                                                      gc * lanes)),
            eps_packed=jnp.asarray(eps_flat.reshape(n_eps_rows,
                                                    ge * lanes)),
            emit_block=jnp.asarray(emit_block_np),
            emit_hot=(jnp.asarray(emit_block_np[:hot_rows].copy())
                      if hot_rows else None),
            hot_rows=hot_rows,
            eps_depth=cls._capped_depth(_eps_depth(fst), eps_depth_cap),
            group=group,
            csr_group=gc,
            eps_group=ge,
            eps_meta_ok=eps_meta_ok,
            max_emit_fanout=int(n_emit.max(initial=0)),
            eps_removed=olabel2 is not None,
            has_emit_olabel=bool((~is_eps & (fst.arc_olabel > 0)).any()),
            emit_compact=emit_compact,
        )

    @staticmethod
    def _capped_depth(computed: Optional[int],
                      cap: Optional[int]) -> Optional[int]:
        if cap is None:
            return computed
        return cap if computed is None else min(computed, cap)

    @property
    def num_states(self) -> int:
        return self.state_packed.shape[0]


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["hash_tab", "state_tab", "small_lm", "start", "uni_next",
                 "uni_weight"],
    meta_fields=["max_backoff", "hash_seed1", "hash_seed2", "hash_mask"])
@dataclasses.dataclass(frozen=True)
class DeviceLm:
    """Backoff LM G' for delta-LM rescoring: dense state-0 + arc hash.

    Three structures replace the reference's binary-searched arc spans +
    1M-entry direct-mapped cache (src/fst.cc:131-154, 292-327):

      uni_next/uni_weight — state 0 (the ARPA unigram/backoff terminal,
        where most walks land, holding a vocab-sized span) as a DENSE
        per-ilabel table: the reference's bucket_0_ fast path
        (src/fst.cc:175-197), one row gather.
      hash_tab — every other (state, ilabel>0) arc in a TWO-CHOICE
        4-way-bucketized hash table: one 64-byte row gather resolves a
        lookup (a second row only when the bucket's overflow bit — the
        sign of the l0 lane — says a colliding key was displaced to its
        alternate bucket).  Replacing the span_bits(~11)-round binary
        search with ~1 probe round cuts the walk's dependent row gathers
        about tenfold (ROADMAP S5 measures the walk on the GPU).
      state_tab — per-state (backoff_next, backoff_weight): the epsilon
        first-arc convention resolved offline, one row gather per miss.

    Bucket row layout (16 x i32): [s0..s3, l0..l3, n0..n3, w0..w3] with
    empty slots s = -1 (keys always have s >= 1, l >= 1).
    """

    hash_tab: jnp.ndarray  # i32 [B, 16] two-choice 4-slot buckets
    state_tab: jnp.ndarray  # i32 [S, 2] (backoff next or -1, weight bits)
    small_lm: jnp.ndarray  # f32 [V] unigram costs to subtract
    start: jnp.ndarray  # i32 scalar: DeltaLmFst start (post-<s>)
    uni_next: jnp.ndarray  # i32 [V] state-0 dense next (-1 = no arc)
    uni_weight: jnp.ndarray  # f32 [V] state-0 dense weight
    max_backoff: int
    hash_seed1: int
    hash_seed2: int
    hash_mask: int  # buckets - 1 (power of two)

    @classmethod
    def build(cls, delta: DeltaLmFst, max_backoff: int = 8) -> "DeviceLm":
        lm = delta.lm
        starts = lm.offsets[:-1]
        nonempty = lm.offsets[:-1] < lm.offsets[1:]
        has_backoff = np.zeros(lm.num_states, bool)
        has_backoff[nonempty] = lm.arc_ilabel[starts[nonempty]] == 0
        # Per-state backoff arc (the epsilon-first convention), packed.
        bo_next = np.full(lm.num_states, -1, np.int32)
        bo_wbits = np.zeros(lm.num_states, np.int32)
        bo_states = np.flatnonzero(has_backoff)
        bo_pos = lm.offsets[bo_states]
        bo_next[bo_states] = lm.arc_next[bo_pos]
        bo_wbits[bo_states] = np.asarray(lm.arc_weight[bo_pos],
                                         np.float32).view(np.int32)
        state_tab = np.stack([bo_next, bo_wbits], axis=1)
        # Dense state-0 table indexed by ilabel (reference bucket_0_).
        n_sym = max(int(lm.arc_ilabel.max(initial=0)) + 1,
                    int(np.asarray(delta.small_lm).size), 1)
        uni_next = np.full(n_sym, -1, np.int32)
        uni_weight = np.zeros(n_sym, np.float32)
        lo0, hi0 = int(lm.offsets[0]), int(lm.offsets[1])
        lab0 = lm.arc_ilabel[lo0:hi0]
        uni_next[lab0] = lm.arc_next[lo0:hi0]
        uni_weight[lab0] = lm.arc_weight[lo0:hi0]
        # Hash all remaining (state >= 1, ilabel >= 1) arcs.
        state_of_arc = np.repeat(
            np.arange(lm.num_states),
            np.diff(lm.offsets.astype(np.int64))).astype(np.int32)
        sel = (lm.arc_ilabel > 0) & (state_of_arc != 0)
        ks, kl = state_of_arc[sel], lm.arc_ilabel[sel].astype(np.int32)
        kn = lm.arc_next[sel].astype(np.int32)
        kw = np.asarray(lm.arc_weight[sel], np.float32).view(np.int32)
        tab, seed1, seed2, mask = cls._build_hash(ks, kl, kn, kw)
        return cls(
            hash_tab=jnp.asarray(tab),
            state_tab=jnp.asarray(state_tab),
            small_lm=jnp.asarray(np.asarray(delta.small_lm, np.float32)),
            start=jnp.int32(delta.start_state()),
            uni_next=jnp.asarray(uni_next),
            uni_weight=jnp.asarray(uni_weight),
            max_backoff=max_backoff,
            hash_seed1=seed1,
            hash_seed2=seed2,
            hash_mask=mask,
        )

    @staticmethod
    def _build_hash(ks, kl, kn, kw, slots: int = 4):
        """Greedy two-choice placement; doubles the table on failure.

        First-choice buckets fill to `slots`; displaced keys mark their
        first bucket's overflow bit (sign of the stored l0 lane) and go
        to their second-choice bucket.  Lookup therefore needs a second
        probe only when the first bucket says so.
        """
        n = ks.size
        if n == 0:
            # A G' whose arcs all live on state 0 (pure unigram LM) hashes
            # nothing: every lookup resolves from the dense uni_next table
            # or misses into the backoff walk.  A minimal all-empty table
            # keeps the device lookup's bucket gather well-defined.
            b = 256
            tab = np.concatenate([np.full((b, slots), -1, np.int32),
                                  np.zeros((b, 3 * slots), np.int32)],
                                 axis=1)
            return tab, 0x1234, 0x9876, b - 1
        b = 1 << max(8, int(np.ceil(np.log2(max(1, n / 2)))))
        for attempt in range(8):
            seed1, seed2 = 0x1234 + attempt, 0x9876 + 3 * attempt
            mask = b - 1
            h1 = _lm_hash(np, ks, kl, seed1, mask)
            h2 = _lm_hash(np, ks, kl, seed2, mask)
            ss = np.full((b, slots), -1, np.int32)
            ll = np.zeros((b, slots), np.int32)
            nn = np.zeros((b, slots), np.int32)
            ww = np.zeros((b, slots), np.int32)
            overflow = np.zeros(b, bool)

            def rank_in_bucket(h):
                order = np.argsort(h, kind="stable")
                hs = h[order]
                first = np.concatenate([[0], np.flatnonzero(
                    hs[1:] != hs[:-1]) + 1])
                start_of = np.zeros(n, np.int64)
                start_of[first] = first
                np.maximum.accumulate(start_of, out=start_of)
                rank = np.arange(n) - start_of
                out = np.empty(n, np.int64)
                out[order] = rank
                return out

            r1 = rank_in_bucket(h1)
            place1 = r1 < slots
            ss[h1[place1], r1[place1]] = ks[place1]
            ll[h1[place1], r1[place1]] = kl[place1]
            nn[h1[place1], r1[place1]] = kn[place1]
            ww[h1[place1], r1[place1]] = kw[place1]
            rest = ~place1
            overflow[h1[rest]] = True
            used = np.bincount(h1[place1], minlength=b)
            h2r = h2[rest]
            r2 = rank_in_bucket(np.where(rest, h2, -1))[rest] \
                if rest.any() else np.zeros(0, np.int64)
            slot2 = used[h2r] + r2
            if (slot2 < slots).all():
                ss[h2r, slot2] = ks[rest]
                ll[h2r, slot2] = kl[rest]
                nn[h2r, slot2] = kn[rest]
                ww[h2r, slot2] = kw[rest]
                # Overflow bit rides the sign of l0.
                ll[overflow, 0] = np.int32(
                    ll[overflow, 0].astype(np.int64) - 2**31)
                tab = np.concatenate([ss, ll, nn, ww], axis=1)
                return tab, seed1, seed2, mask
            b *= 2
        raise CorruptionError("delta-LM hash build failed to converge")


def lm_propagate_capped(dlm: DeviceLm, states: jnp.ndarray,
                        labels: jnp.ndarray, cap: int):
    """lm_propagate over only the ACTIVE (label > 0) lanes, compacted.

    The backoff walk pays hash/backoff row gathers per lane per iteration
    over EVERY lane it is given, but word-emitting candidates are a small
    fraction of an expansion (most arcs carry olabel 0).  Compacting the
    active lanes into `cap` slots makes the walk's cost proportional to
    the number of WORDS in flight, not to the expansion capacity:

      1. segment-sort compaction (compact_mask) books the active lanes
         with segment sorts + ONE cap-row gather
      2. bounded backoff walk over the cap compacted lanes
      3. a cap-row scatter maps (state', weight) back to their lanes

    Returns (next_states, delta_weights, needed): `needed` is the number
    of active lanes in this call — if it exceeds cap, the overflow lanes
    kept their state with zero weight (WRONG results), so the caller must
    surface it exactly like a CSR expansion overflow.  cap <= 0 runs the
    uncapped walk (exact, never truncates) and still reports `needed`
    for capacity sizing telemetry.
    """
    active = labels > 0
    needed = jnp.sum(active.astype(jnp.int32))
    e = states.shape[0]
    if cap <= 0 or cap >= e:
        ns, w = lm_propagate(dlm, states, labels)
        return ns, w, needed
    # Segment-sort compaction (compact_mask): a cumsum+searchsorted
    # compaction would cost log2(E) rounds of cap-wide row gathers; the
    # segment machinery books survivors with sorts and pays ONE cap-row
    # gather.
    (sub_states, sub_labels), sub_ok, _total, lane = compact_mask(
        active, [states, labels], cap)
    sub_states = jnp.where(sub_ok, sub_states, 0)
    sub_labels = jnp.where(sub_ok, sub_labels, 0)
    ns, w = lm_propagate(dlm, sub_states, sub_labels)
    # Scatter the cap results back to their lanes (cap rows — cheap; the
    # inverse E-row gather costs ~10x at expansion widths).  Invalid
    # compact slots scatter out of range (dropped) so lane 0 keeps its
    # own result.
    lane = jnp.where(sub_ok, lane, e)
    out_s = states.at[lane].set(jnp.where(sub_ok, ns, 0), mode="drop")
    out_w = jnp.zeros(e, jnp.float32).at[lane].set(
        jnp.where(sub_ok, w, 0.0), mode="drop")
    return out_s, out_w, needed


def lm_propagate(dlm: Optional[DeviceLm], states: jnp.ndarray,
                 labels: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Vectorized DeltaLmFst::GetArc with backoff walk.

    states, labels: i32 [E].  Returns (next_states, delta_weights).
    labels == 0 keep the state with zero weight; a full backoff miss also
    keeps the state (reference PropogateLm, src/decoder.cc:123-141).

    Per while_loop iteration the walk pays TWO cap-wide row gathers (one
    hash bucket, one state_tab backoff row) plus a rare second-choice
    probe iteration — against the old design's span_bits(~11)
    binary-search rounds + 2 span-bound rounds.  Dependent row gathers
    set the walk's cost, so iterations are the budget: a found word
    costs 1, each backoff hop 1, a displaced hash key 1 extra.
    """
    if dlm is None:
        return states, jnp.zeros_like(states, jnp.float32)

    # Loop-invariant per-label fetches: state-0 dense arc + unigram cost.
    l_c = jnp.clip(labels, 0, dlm.uni_next.shape[0] - 1)
    uni_nxt = dlm.uni_next[l_c]
    uni_w = dlm.uni_weight[l_c]
    lab_f = labels

    def lookup(s, phase2):
        """One probe round: bucket row gather + 4-slot compare.

        Returns (resolved, hit, nxt, w, need2): `resolved` lanes either
        hit or definitively missed; `need2` lanes must re-probe their
        second-choice bucket next iteration.
        """
        at0 = s == 0
        h1 = _lm_hash(jnp, s, lab_f, dlm.hash_seed1, dlm.hash_mask)
        h2 = _lm_hash(jnp, s, lab_f, dlm.hash_seed2, dlm.hash_mask)
        row = dlm.hash_tab[jnp.where(phase2, h2, h1)]  # [E, 16] row gather
        rs, rl = row[:, 0:4], row[:, 4:8]
        ov = rl[:, 0] < 0  # overflow bit rides l0's sign
        rl = rl & jnp.int32(0x7FFFFFFF)
        match = (rs == s[:, None]) & (rl == lab_f[:, None])
        hit = jnp.any(match, axis=1)
        nxt = jnp.sum(jnp.where(match, row[:, 8:12], 0), axis=1)
        w = jax.lax.bitcast_convert_type(
            jnp.sum(jnp.where(match, row[:, 12:16], 0), axis=1),
            jnp.float32)
        # State 0 resolves from the dense table instead.
        hit = jnp.where(at0, uni_nxt >= 0, hit)
        nxt = jnp.where(at0, uni_nxt, nxt)
        w = jnp.where(at0, uni_w, w)
        need2 = ~hit & ~at0 & ov & ~phase2
        return hit, nxt, w, need2

    active0 = labels > 0
    cur = jnp.where(active0, states, 0)
    zero_w = jnp.zeros_like(states, jnp.float32)
    zero_b = jnp.zeros_like(active0)

    # carry: (cur, weight, active, done, failed, phase2, backoff_count)
    def cond(c):
        return jnp.any(c[2])

    def body(c):
        cur, weight, active, done, failed, phase2, bo_it = c
        hit, nxt, w, need2 = lookup(cur, phase2)
        found_now = active & hit
        retry = active & need2
        miss = active & ~hit & ~need2
        # Misses follow the state's backoff arc if present (resolved
        # offline into state_tab).
        st = dlm.state_tab[jnp.clip(cur, 0, dlm.state_tab.shape[0] - 1)]
        bo_next = st[:, 0]
        bo_w = jax.lax.bitcast_convert_type(st[:, 1], jnp.float32)
        bo_ok = miss & (bo_next >= 0)
        cur = jnp.where(found_now, nxt, jnp.where(bo_ok, bo_next, cur))
        weight = jnp.where(found_now, weight + w,
                           jnp.where(bo_ok, weight + bo_w, weight))
        done = done | found_now
        over = bo_ok & (bo_it >= dlm.max_backoff)
        failed = failed | (miss & (bo_next < 0)) | over
        active = (bo_ok & ~over) | retry
        bo_it = bo_it + jnp.where(bo_ok, 1, 0)
        return cur, weight, active, done, failed, retry, bo_it

    init = (cur, zero_w, active0, zero_b, zero_b, zero_b,
            jnp.zeros_like(states))
    cur, weight, _, done, failed, _, _ = jax.lax.while_loop(cond, body,
                                                            init)
    # GetArc success: subtract the unigram cost (src/fst.cc:274-281).
    sub = dlm.small_lm[jnp.clip(labels, 0, dlm.small_lm.shape[0] - 1)]
    ok = active0 & done & ~failed
    out_state = jnp.where(ok, cur, states)
    out_weight = jnp.where(ok, weight - sub, 0.0)
    return out_state, out_weight
