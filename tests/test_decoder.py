"""Decoder differential tests: device beam search vs the numpy oracle.

Pattern mirrors the reference's naive-vs-optimized differential tests
(test/gemm_test.cc): the dense device decoder must produce the same Viterbi
word sequence and cost as the dict-based oracle on graphs where pruning
never truncates.
"""

import numpy as np
import pytest

from catears_tpu.decode.beam import BeamConfig
from catears_tpu.decode.decoder import Decoder, decode_batch
from catears_tpu.decode.oracle import OracleDecoder
from catears_tpu.graph.fst import DeltaLmFst, FlatFst, LmFst
from catears_tpu.io.symbols import SymbolTable
from catears_tpu.tools.toy import make_phone_loop_graph


def random_fst(rng, num_states=12, num_trans=10, eps_prob=0.25,
               max_olabel=5) -> FlatFst:
    """Random connected-ish WFST with emitting and epsilon arcs."""
    arcs = []
    for s in range(num_states):
        for _ in range(rng.randint(1, 5)):
            dst = rng.randint(0, num_states)
            if rng.rand() < eps_prob:
                ilabel = 0
                olabel = rng.randint(0, max_olabel + 1)
                # avoid zero-weight epsilon self loops
                weight = rng.rand() * 2 + 0.05
                if dst == s:
                    continue
            else:
                ilabel = rng.randint(1, num_trans + 1)
                olabel = rng.randint(0, max_olabel + 1)
                weight = rng.rand() * 3
            arcs.append((s, dst, ilabel, olabel, weight))
    arr = np.array(arcs, dtype=np.float64)
    final = np.where(rng.rand(num_states) < 0.4,
                     (rng.rand(num_states) * 2).astype(np.float32),
                     np.float32(np.inf))
    return FlatFst.from_arrays(
        start=0, final=final,
        state_of_arc=arr[:, 0].astype(np.int64),
        arc_next=arr[:, 1].astype(np.int32),
        arc_ilabel=arr[:, 2].astype(np.int32),
        arc_olabel=arr[:, 3].astype(np.int32),
        arc_weight=arr[:, 4].astype(np.float32))


def run_both(fst, tid2pdf, logp, config, delta_lm=None):
    oracle = OracleDecoder(fst, tid2pdf, am_scale=config.am_scale,
                           beam=config.beam, beam_size=config.beam_size,
                           max_eps_iters=config.max_eps_iters,
                           delta_lm=delta_lm)
    for row in logp:
        oracle.process(row)
    oracle_hyp = oracle.best_path(end_of_stream=True)

    dec = Decoder(fst, tid2pdf, am_scale=config.am_scale, delta_lm=delta_lm,
                  config=config, chunk_frames=7)
    dec.process(logp)
    dec.end_of_stream()
    device_hyp = dec.best_path()
    return oracle_hyp, device_hyp


SMALL_CFG = BeamConfig(beam_size=128, expand_size=1024, eps_expand_size=512,
                       max_eps_iters=6, beam=1e9, am_scale=0.1)


class TestDeviceVsOracle:
    @pytest.mark.parametrize("seed", range(6))
    def test_random_graphs_unpruned(self, seed):
        rng = np.random.RandomState(seed)
        fst = random_fst(rng)
        num_trans = 10
        tid2pdf = np.arange(num_trans + 1, dtype=np.int32)
        logp = np.log(rng.dirichlet(np.ones(num_trans + 1),
                                    size=15)).astype(np.float32)
        o, d = run_both(fst, tid2pdf, logp, SMALL_CFG)
        assert d.words == o.words, f"seed {seed}"
        assert abs(d.weight - o.weight) < 1e-3

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_phone_loop_graph(self, seed):
        rng = np.random.RandomState(100 + seed)
        graph = make_phone_loop_graph(rng, num_words=5, num_pdfs=24)
        fst = FlatFst.from_raw(graph.fst)
        t = 30
        logp = np.log(rng.dirichlet(np.ones(24), size=t)).astype(np.float32)
        o, d = run_both(fst, graph.tid2pdf, logp, SMALL_CFG)
        assert d.words == o.words
        assert len(d.words) > 0  # something must be decoded
        assert abs(d.weight - o.weight) < 1e-3

    def test_with_beam_threshold(self):
        """Narrow beam active in both: identical pruning decisions."""
        rng = np.random.RandomState(7)
        fst = random_fst(rng, num_states=20)
        tid2pdf = np.arange(11, dtype=np.int32)
        logp = np.log(rng.dirichlet(np.ones(11), size=20)).astype(np.float32)
        cfg = BeamConfig(beam_size=128, expand_size=1024, eps_expand_size=512,
                         max_eps_iters=6, beam=8.0, am_scale=0.1)
        o, d = run_both(fst, tid2pdf, logp, cfg)
        assert d.words == o.words
        assert abs(d.weight - o.weight) < 1e-3

    @pytest.mark.parametrize("arc_group", [1, 2, 4, 8])
    def test_high_fanout_overflow(self, arc_group):
        """States with fanout >> arc_group exercise the CSR overflow pass.

        The 30-word phone loop's loop state has 30 emitting arcs, far more
        than any block width, so correctness requires pass B (overflow).
        """
        rng = np.random.RandomState(42)
        graph = make_phone_loop_graph(rng, num_words=30, num_pdfs=32)
        fst = FlatFst.from_raw(graph.fst)
        logp = np.log(rng.dirichlet(np.ones(32), size=25)).astype(np.float32)
        oracle = OracleDecoder(fst, graph.tid2pdf,
                               am_scale=SMALL_CFG.am_scale,
                               beam=SMALL_CFG.beam,
                               beam_size=SMALL_CFG.beam_size,
                               max_eps_iters=SMALL_CFG.max_eps_iters)
        for row in logp:
            oracle.process(row)
        o = oracle.best_path(end_of_stream=True)
        dec = Decoder(fst, graph.tid2pdf, config=SMALL_CFG, chunk_frames=7,
                      arc_group=arc_group)
        dec.process(logp)
        dec.end_of_stream()
        d = dec.best_path()
        assert d.words == o.words
        assert abs(d.weight - o.weight) < 1e-3

    def test_partial_hypothesis(self):
        """best_path before end_of_stream skips final weights."""
        rng = np.random.RandomState(3)
        graph = make_phone_loop_graph(rng, num_words=4, num_pdfs=16)
        fst = FlatFst.from_raw(graph.fst)
        logp = np.log(rng.dirichlet(np.ones(16), size=12)).astype(np.float32)

        oracle = OracleDecoder(fst, graph.tid2pdf, beam=1e9)
        dec = Decoder(fst, graph.tid2pdf, config=SMALL_CFG, chunk_frames=4)
        for row in logp:
            oracle.process(row)
        dec.process(logp)
        dec._flush(force=True)  # decode everything without EOS flag
        o = oracle.best_path(end_of_stream=False)
        d = dec.best_path()
        assert d.words == o.words


class TestDeltaLm:
    @pytest.fixture(scope="class")
    def delta(self, data_dir):
        import os
        lm = LmFst.read_lm(os.path.join(data_dir, "G.pfst"))
        table = SymbolTable.read(os.path.join(data_dir, "lm.words.txt"))
        from catears_tpu.io.binfmt import read_vec0_file
        small = read_vec0_file(os.path.join(data_dir, "lm.1order.bin"))
        return DeltaLmFst(small, lm, table)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_device_vs_oracle_with_lm(self, delta, seed):
        """Online big-LM composition: decode states are (hclg, lm) pairs."""
        rng = np.random.RandomState(200 + seed)
        vocab = delta.small_lm.size
        # Random HCLG-ish graph whose olabels are real LM word-ids
        arcs = []
        num_states, num_trans = 10, 8
        for s in range(num_states):
            for _ in range(rng.randint(1, 4)):
                dst = rng.randint(0, num_states)
                ilabel = rng.randint(1, num_trans + 1)
                olabel = rng.randint(3, min(vocab, 200))
                arcs.append((s, dst, ilabel, olabel, rng.rand() * 2))
            # epsilon arc without olabel
            if s + 1 < num_states:
                arcs.append((s, s + 1, 0, 0, rng.rand() + 0.1))
        arr = np.array(arcs, dtype=np.float64)
        final = np.zeros(num_states, np.float32)
        fst = FlatFst.from_arrays(
            start=0, final=final,
            state_of_arc=arr[:, 0].astype(np.int64),
            arc_next=arr[:, 1].astype(np.int32),
            arc_ilabel=arr[:, 2].astype(np.int32),
            arc_olabel=arr[:, 3].astype(np.int32),
            arc_weight=arr[:, 4].astype(np.float32))
        tid2pdf = np.arange(num_trans + 1, dtype=np.int32)
        logp = np.log(rng.dirichlet(np.ones(num_trans + 1),
                                    size=10)).astype(np.float32)
        o, d = run_both(fst, tid2pdf, logp, SMALL_CFG, delta_lm=delta)
        assert d.words == o.words
        assert abs(d.weight - o.weight) < 1e-2


class TestBatchDecode:
    def test_batch_matches_single(self):
        rng = np.random.RandomState(9)
        graph = make_phone_loop_graph(rng, num_words=5, num_pdfs=24)
        fst = FlatFst.from_raw(graph.fst)
        b, tmax = 3, 25
        lengths = [25, 17, 9]
        logp = np.log(rng.dirichlet(np.ones(24), size=(b, tmax))
                      ).astype(np.float32)
        hyps = decode_batch(fst, graph.tid2pdf, logp, lengths,
                            config=SMALL_CFG, chunk_frames=10)
        for u in range(b):
            dec = Decoder(fst, graph.tid2pdf, config=SMALL_CFG)
            dec.process(logp[u, :lengths[u]])
            dec.end_of_stream()
            single = dec.best_path()
            assert hyps[u].words == single.words
            assert abs(hyps[u].weight - single.weight) < 1e-3

    def test_device_backtrace_matches_host(self):
        """The production device backtrace (reversed scan + host final
        selection) must equal the per-frame host-trace walk on ragged
        batches — with and without delta-LM final weights."""
        import types

        from catears_tpu.tools.toy import make_toy_lm

        rng = np.random.RandomState(11)
        graph = make_phone_loop_graph(rng, num_words=6, num_pdfs=24)
        fst = FlatFst.from_raw(graph.fst)
        lm_raw, small_lm = make_toy_lm(rng, num_words=6, bos_id=7, eos_id=8)
        toy_delta = DeltaLmFst(
            small_lm, LmFst(**FlatFst.from_raw(lm_raw).__dict__),
            types.SimpleNamespace(bos_id=7, eos_id=8))
        b, tmax = 4, 30
        lengths = [30, 22, 13, 5]
        logp = np.log(rng.dirichlet(np.ones(24), size=(b, tmax))
                      ).astype(np.float32)
        for delta in (None, toy_delta):
            dev = decode_batch(fst, graph.tid2pdf, logp, lengths,
                               config=SMALL_CFG, chunk_frames=10,
                               delta_lm=delta, device_backtrace=True)
            host = decode_batch(fst, graph.tid2pdf, logp, lengths,
                                config=SMALL_CFG, chunk_frames=10,
                                delta_lm=delta, device_backtrace=False)
            for u in range(b):
                assert dev[u].words == host[u].words, (u, delta is None)
                assert abs(dev[u].weight - host[u].weight) < 1e-3


class TestBeamDeath:
    def test_dead_end_freezes_last_beam(self):
        """A dead-end graph region must not wipe the partial hypothesis."""
        # Chain: 0 -a(olabel 1)-> 1 -b(olabel 2)-> 2 (no outgoing arcs)
        arcs = np.array([
            (0, 1, 1, 1, 0.5),
            (1, 2, 2, 2, 0.5),
        ])
        final = np.full(3, np.inf, np.float32)
        final[2] = 0.0
        fst = FlatFst.from_arrays(
            start=0, final=final,
            state_of_arc=arcs[:, 0].astype(np.int64),
            arc_next=arcs[:, 1].astype(np.int32),
            arc_ilabel=arcs[:, 2].astype(np.int32),
            arc_olabel=arcs[:, 3].astype(np.int32),
            arc_weight=arcs[:, 4].astype(np.float32))
        tid2pdf = np.arange(3, dtype=np.int32)
        logp = np.log(np.full((5, 3), 1 / 3, np.float32))  # 5 frames > path

        o, d = run_both(fst, tid2pdf, logp, SMALL_CFG)
        # Both survive past the death at frame 3 and keep the full path
        assert d.words == o.words == [1, 2]


class TestOverflowSafety:
    """Expansion truncation must be reported, never silent."""

    def _graph(self, seed=5, num_words=40):
        rng = np.random.RandomState(seed)
        graph = make_phone_loop_graph(rng, num_words=num_words, num_pdfs=32)
        logp = np.log(rng.dirichlet(np.ones(32), size=30)).astype(np.float32)
        return graph, logp

    def test_too_small_expand_reports(self):
        """A deliberately undersized emitting capacity raises, not garbage.

        The 40-word loop state has 40 emitting arcs; with arc_group=1 and
        expand_size=8 the CSR overflow pass must truncate and flag it.
        """
        from catears_tpu.utils.errors import BeamCapacityError
        graph, logp = self._graph()
        fst = FlatFst.from_raw(graph.fst)
        cfg = BeamConfig(beam_size=64, expand_size=8, eps_expand_size=512,
                         max_eps_iters=6, beam=1e9)
        dec = Decoder(fst, graph.tid2pdf, config=cfg, arc_group=1)
        dec.process(logp)
        dec.end_of_stream()
        assert dec.overflowed
        with pytest.raises(BeamCapacityError):
            dec.best_path()

    def test_too_small_eps_expand_reports(self):
        """Undersized epsilon capacity is flagged by the closure pass.

        The default pipeline removes epsilons from the frame loop
        entirely (eps capacity then only serves the init closure), so
        this exercises the closure path with close_eps=False.
        """
        from catears_tpu.utils.errors import BeamCapacityError
        graph, logp = self._graph()
        fst = FlatFst.from_raw(graph.fst)
        # Word-end eps arcs: with a huge beam, dozens of word-final states
        # are simultaneously active, each with one eps arc; capacity 2
        # cannot hold them.
        cfg = BeamConfig(beam_size=256, expand_size=4096, eps_expand_size=2,
                         max_eps_iters=6, beam=1e9)
        dec = Decoder(fst, graph.tid2pdf, config=cfg, arc_group=1,
                      close_eps=False)
        dec.process(logp)
        dec.end_of_stream()
        assert dec.overflowed
        with pytest.raises(BeamCapacityError):
            dec.best_path()

    def test_batch_overflow_reports(self):
        from catears_tpu.utils.errors import BeamCapacityError
        graph, logp = self._graph()
        fst = FlatFst.from_raw(graph.fst)
        cfg = BeamConfig(beam_size=64, expand_size=8, eps_expand_size=512,
                         max_eps_iters=6, beam=1e9)
        with pytest.raises(BeamCapacityError):
            decode_batch(fst, graph.tid2pdf, logp[None], config=cfg,
                         arc_group=1, retry_on_overflow=False)

    def test_batch_overflow_regrows_and_retries(self):
        """A deliberately undersized config still returns CORRECT
        transcripts: the runtime regrows geometry from the overflow's
        high-water telemetry and re-decodes once.  The error only escapes after a
        failed retry."""
        from catears_tpu.utils.errors import BeamCapacityError
        graph, logp = self._graph()
        fst = FlatFst.from_raw(graph.fst)
        small = BeamConfig(beam_size=64, expand_size=8, eps_expand_size=512,
                           max_eps_iters=6, beam=1e9)
        want = decode_batch(fst, graph.tid2pdf, logp[None], arc_group=1)
        got = decode_batch(fst, graph.tid2pdf, logp[None], config=small,
                           arc_group=1)  # retry_on_overflow defaults True
        assert got[0].words == want[0].words
        assert abs(got[0].weight - want[0].weight) < 1e-3
        # hiwater rides the error so the retry can size from demand
        try:
            decode_batch(fst, graph.tid2pdf, logp[None], config=small,
                         arc_group=1, retry_on_overflow=False)
        except BeamCapacityError as e:
            assert e.hiwater is not None and e.hiwater[0] > 8

    def test_auto_capacity_never_overflows(self):
        """Default (config=None) sizes capacities from expansion_bounds."""
        graph, logp = self._graph()
        fst = FlatFst.from_raw(graph.fst)
        dec = Decoder(fst, graph.tid2pdf, arc_group=1)
        dec.process(logp)
        dec.end_of_stream()
        assert not dec.overflowed
        dec.best_path()  # must not raise

    def test_capacity_high_water(self):
        """hiwater reports the slots a decode needed; sizing to it works.

        Decode once with generous capacities, read the high-water marks,
        then re-decode with capacities == hiwater (no overflow) and with
        eps capacity below it (overflow flagged).
        """
        from catears_tpu.utils.errors import BeamCapacityError
        graph, logp = self._graph()
        fst = FlatFst.from_raw(graph.fst)
        big = BeamConfig(beam_size=64, expand_size=4096,
                         eps_expand_size=4096, max_eps_iters=6, beam=1e9)
        # Closure path (close_eps=False) so BOTH the emit and eps lanes
        # report; the default eps-removed pipeline uses the eps capacity
        # only at init.
        dec = Decoder(fst, graph.tid2pdf, config=big, arc_group=1,
                      close_eps=False)
        dec.process(logp)
        dec.end_of_stream()
        assert not dec.overflowed
        hyp = dec.best_path()
        hw_emit, hw_eps, _, _, _ = dec.capacity_high_water
        assert 0 < hw_emit <= big.expand_size
        assert 0 < hw_eps <= big.eps_expand_size

        tight = BeamConfig(beam_size=64, expand_size=max(hw_emit, 1),
                           eps_expand_size=max(hw_eps, 1),
                           max_eps_iters=6, beam=1e9)
        dec2 = Decoder(fst, graph.tid2pdf, config=tight, arc_group=1,
                       close_eps=False)
        dec2.process(logp)
        dec2.end_of_stream()
        assert not dec2.overflowed
        assert dec2.best_path().words == hyp.words

        small = BeamConfig(beam_size=64, expand_size=max(hw_emit, 1),
                           eps_expand_size=max(hw_eps // 2, 1),
                           max_eps_iters=6, beam=1e9)
        dec3 = Decoder(fst, graph.tid2pdf, config=small, arc_group=1,
                       close_eps=False)
        dec3.process(logp)
        dec3.end_of_stream()
        assert dec3.overflowed
        with pytest.raises(BeamCapacityError):
            dec3.best_path()

        # Default eps-removed pipeline: emit sizing still round-trips.
        dec4 = Decoder(fst, graph.tid2pdf, config=big, arc_group=1)
        dec4.process(logp)
        dec4.end_of_stream()
        assert not dec4.overflowed
        hw4_emit, _, _, _, _ = dec4.capacity_high_water
        tight4 = BeamConfig(beam_size=64, expand_size=max(hw4_emit, 1),
                            eps_expand_size=64, max_eps_iters=6, beam=1e9)
        dec5 = Decoder(fst, graph.tid2pdf, config=tight4, arc_group=1)
        dec5.process(logp)
        dec5.end_of_stream()
        assert not dec5.overflowed
        assert dec5.best_path().words == dec4.best_path().words

    def test_expansion_bounds_exact(self):
        """Bounds equal the hand-computed worst case on a known graph."""
        from catears_tpu.graph.device import expansion_bounds
        graph, _ = self._graph(num_words=10)
        fst = FlatFst.from_raw(graph.fst)
        n_all = np.diff(fst.offsets)
        state_of_arc = np.repeat(np.arange(fst.num_states), n_all)
        is_eps = fst.arc_ilabel == 0
        n_eps = np.bincount(state_of_arc[is_eps],
                            minlength=fst.num_states)
        # each state's first emitting self-loop rides the block row
        has_self = np.zeros(fst.num_states, bool)
        has_self[state_of_arc[~is_eps
                              & (fst.arc_next == state_of_arc)]] = True
        n_emit = n_all - n_eps - has_self
        for g in (1, 4):
            for k in (2, 64):
                eb, epsb = expansion_bounds(fst, g, k)
                over = -(-np.maximum(n_emit - g, 0) // g)
                eps_r = -(-n_eps // g)
                exp_e = g * np.sort(over)[::-1][:k].sum()
                exp_eps = g * np.sort(eps_r)[::-1][:k].sum()
                assert eb == exp_e and epsb == exp_eps, (g, k)

    def test_corrupt_ilabel_fails_loudly(self):
        """Out-of-range transition-ids refuse to build."""
        from catears_tpu.graph.device import DeviceFst
        from catears_tpu.utils.errors import CorruptionError
        graph, _ = self._graph(num_words=4)
        fst = FlatFst.from_raw(graph.fst)
        bad_tid2pdf = graph.tid2pdf[:max(2, graph.tid2pdf.size // 2)]
        with pytest.raises(CorruptionError):
            DeviceFst.build(fst, bad_tid2pdf)


class TestTrieGraph:
    """mkgraph-shaped benchmark graph (tools/biggraph.py): correctness of
    the generator + device decode on planted-path pseudo-likelihoods."""

    def _make(self, seed=1, **kw):
        from catears_tpu.tools.biggraph import make_trie_graph
        rng = np.random.RandomState(seed)
        defaults = dict(num_words=120, num_phones=25, bigram_states=30,
                        variants=2)
        defaults.update(kw)
        return rng, make_trie_graph(rng, **defaults)

    def test_structure(self):
        _, g = self._make()
        f = g.fst
        fanout = np.diff(f.offsets)
        # Determinized-lexicon shape: fanout bounded by phone inventory,
        # not vocab; word-end epsilons present; bounded epsilon depth.
        assert fanout.max() <= 25 + 5
        assert (f.arc_ilabel == 0).sum() >= 120  # word ends + backoffs
        from catears_tpu.graph.device import _eps_depth
        assert _eps_depth(f) == 2
        assert (g.fst.arc_ilabel <= 2 * g.num_pdfs).all()
        # every word has a pdf path of 3 per phone
        lens = np.diff(g.word_pdf_off[:-1])
        assert lens[1:].min() >= 3 * 3 and lens[1:].max() <= 8 * 3

    def test_planted_decode_matches_oracle_and_truth(self):
        from catears_tpu.tools.biggraph import plant_logp
        rng, g = self._make()
        logp, words = plant_logp(rng, g, 1, 120)
        cfg = BeamConfig(beam_size=256, expand_size=2048,
                         eps_expand_size=1024, max_eps_iters=4,
                         beam=1e9, am_scale=0.1)
        o, d = run_both(g.fst, g.tid2pdf, logp[0], cfg)
        assert d.words == o.words
        assert abs(d.weight - o.weight) < 1e-3
        # the decode recovers the planted words (modulo a trailing
        # partial word cut by the frame limit)
        assert d.words[:len(words[0])] == words[0]

    def test_planted_decode_with_big_delta_lm(self):
        """Trie HCLG + ARPA-shaped G' rescoring: device == oracle.

        End-to-end check of the delta-LM decode path at (scaled-down)
        bench geometry: the trie emits word olabels, lm_propagate walks
        bigram/trigram histories with the dense state-0 fast path, and
        the beam dedups on (state, lm) pairs.
        """
        from catears_tpu.tools.biggraph import make_big_lm, plant_logp
        rng, g = self._make()
        big = make_big_lm(np.random.RandomState(9), num_words=g.num_words)
        logp, words = plant_logp(rng, g, 1, 80)
        cfg = BeamConfig(beam_size=128, expand_size=2048,
                         eps_expand_size=1024, max_eps_iters=4,
                         beam=1e9, am_scale=0.1)
        o, d = run_both(g.fst, g.tid2pdf, logp[0], cfg,
                        delta_lm=big.delta_lm())
        assert d.words == o.words
        assert abs(d.weight - o.weight) < 1e-2

    def test_capped_lm_walk_exact_and_overflow_guarded(self):
        """lm_expand_size compaction: identical transcript when the cap
        covers the lm high-water mark; BeamCapacityError when it can't.
        """
        import dataclasses

        from catears_tpu.decode.decoder import Decoder
        from catears_tpu.tools.biggraph import make_big_lm, plant_logp
        from catears_tpu.utils.errors import BeamCapacityError
        rng, g = self._make()
        big = make_big_lm(np.random.RandomState(9), num_words=g.num_words)
        logp, _ = plant_logp(rng, g, 1, 80)
        cfg = BeamConfig(beam_size=128, expand_size=2048,
                         eps_expand_size=1024, max_eps_iters=4,
                         beam=1e9, am_scale=0.1)

        def decode(c):
            dec = Decoder(g.fst, g.tid2pdf, delta_lm=big.delta_lm(),
                          config=c, chunk_frames=7)
            dec.process(logp[0])
            dec.end_of_stream()
            return dec

        ref = decode(cfg)  # uncapped walk, reports lm high-water
        hw_lm = ref.capacity_high_water[2]
        assert hw_lm > 0
        capped = decode(dataclasses.replace(cfg, lm_expand_size=hw_lm))
        assert capped.best_path().words == ref.best_path().words
        assert capped.capacity_high_water[2] == hw_lm
        tiny = decode(dataclasses.replace(cfg, lm_expand_size=1))
        with pytest.raises(BeamCapacityError):
            tiny.best_path()

    def test_auto_capacity_with_delta_lm_on_big_graph(self):
        """safe_config + delta-LM: the (state, lm)-pair worst case is
        K * max_rows (astronomical); auto capacity must stay within the
        lm_dup_factor envelope AND the planted decode must not overflow
        at that capacity.
        """
        from catears_tpu.decode.decoder import decode_batch, safe_config
        from catears_tpu.graph.device import expansion_bounds
        from catears_tpu.graph.transform import close_epsilons
        from catears_tpu.tools.biggraph import make_big_lm, plant_logp
        rng, g = self._make(num_words=400, num_phones=40, bigram_states=120)
        big = make_big_lm(np.random.RandomState(3), num_words=g.num_words)
        closed, ok = close_epsilons(g.fst)
        assert ok
        base = BeamConfig(beam_size=256, expand_size=4, eps_expand_size=4,
                          max_eps_iters=4, beam=1e9, am_scale=0.1)
        cfg = safe_config(closed, 2, base, has_lm=True, csr_group=8)
        eb_d, epsb_d = expansion_bounds(closed, 2, 256,
                                        distinct_states=True, csr_group=8)
        eb_w, _ = expansion_bounds(closed, 2, 256, distinct_states=False,
                                   csr_group=8)
        assert cfg.expand_size <= 4 * eb_d < eb_w  # no K*max_rows blowup
        logp, words = plant_logp(rng, g, 1, 100)
        hyps = decode_batch(g.fst, g.tid2pdf, logp, config=cfg,
                            delta_lm=big.delta_lm(), arc_group=2,
                            csr_group=8)
        # no BeamCapacityError raised = no overflow at auto capacity; the
        # decode still tracks the planted paths
        assert hyps[0].words[:len(words[0])] == words[0]


class TestSelectCompact:
    """Threshold-prefilter + compaction selection (BeamConfig.select_compact)
    must be bit-equivalent to the classic full-width sorts, and truncation
    must be loud (same contract as the CSR capacities)."""

    def _setup(self):
        from catears_tpu.tools.biggraph import make_trie_graph, plant_logp
        rng = np.random.RandomState(3)
        g = make_trie_graph(rng, num_words=120, num_phones=25,
                            bigram_states=30, variants=2)
        logp, _ = plant_logp(rng, g, 1, 120)
        return g, logp[0]

    def _decode(self, g, logp, beam=12.0, **kw):
        cfg = BeamConfig(beam_size=256, expand_size=2048,
                         eps_expand_size=1024, max_eps_iters=4,
                         beam=beam, am_scale=0.1, **kw)
        dec = Decoder(g.fst, g.tid2pdf, config=cfg, chunk_frames=7)
        dec.process(logp)
        dec.end_of_stream()
        return dec

    def test_compact_matches_classic(self):
        g, logp = self._setup()
        ref = self._decode(g, logp)
        com = self._decode(g, logp, select_compact=1024)
        assert not com.overflowed
        a, b = ref.best_path(), com.best_path()
        assert a.words == b.words
        assert abs(a.weight - b.weight) < 1e-5
        # demand telemetry reported and sizing to it round-trips
        need = com.capacity_high_water[3]
        assert 0 < need <= 1024
        tight = self._decode(g, logp, select_compact=need)
        assert not tight.overflowed
        assert tight.best_path().words == a.words

    def test_compact_overflow_is_loud(self):
        from catears_tpu.utils.errors import BeamCapacityError
        g, logp = self._setup()
        # beam=1e9 disables the threshold, so every valid candidate
        # survives the prefilter and the K-clamped compact capacity
        # (256 slots) must truncate — loudly.
        need = self._decode(g, logp, beam=1e9, select_compact=2048) \
            .capacity_high_water[3]
        assert need > 256
        small = self._decode(g, logp, beam=1e9, select_compact=1)
        assert small.overflowed
        with pytest.raises(BeamCapacityError):
            small.best_path()


class TestCompactEmit:
    """The compact 9-lane emit row must decode EXACTLY like the classic
    18-lane layout (it packs the same fields; graph/device.py layout)."""

    def _dec(self, g, compact, beam=256):
        from catears_tpu.decode.decoder import BatchDecoder
        from catears_tpu.graph.device import DeviceFst
        from catears_tpu.graph.transform import prepare_decode_graph

        cfg = BeamConfig(beam_size=beam, expand_size=4096,
                         eps_expand_size=2048, max_eps_iters=3)
        dec_fst, olab2, mode = prepare_decode_graph(g.fst)
        assert mode == "eps_free"
        dfst = DeviceFst.build(dec_fst, g.tid2pdf, group=2,
                               eps_depth_cap=1, olabel2=olab2,
                               compact=compact)
        assert dfst.emit_compact == compact
        return BatchDecoder(dec_fst, g.tid2pdf, config=cfg, dfst=dfst)

    def test_compact_matches_classic(self):
        from catears_tpu.tools.biggraph import make_trie_graph, plant_logp

        rng = np.random.RandomState(5)
        g = make_trie_graph(rng, num_words=300, num_phones=25,
                            bigram_states=50, variants=2)
        logp, words = plant_logp(rng, g, 3, 120)
        classic = self._dec(g, False).decode(logp)
        packed = self._dec(g, True).decode(logp)
        for u in range(3):
            assert packed[u].words == classic[u].words
            assert abs(packed[u].weight - classic[u].weight) < 1e-3
        assert any(h.words for h in packed)

    def test_guard_falls_back(self):
        """Graphs whose fields exceed the packed widths keep the classic
        layout (e.g. arc_group != 2)."""
        from catears_tpu.graph.device import DeviceFst
        from catears_tpu.graph.transform import prepare_decode_graph
        from catears_tpu.tools.biggraph import make_trie_graph

        g = make_trie_graph(np.random.RandomState(1), num_words=100,
                            num_phones=20, bigram_states=20, variants=2)
        dec_fst, olab2, _ = prepare_decode_graph(g.fst)
        d4 = DeviceFst.build(dec_fst, g.tid2pdf, group=4,
                             eps_depth_cap=1, olabel2=olab2)
        assert not d4.emit_compact
        d2 = DeviceFst.build(dec_fst, g.tid2pdf, group=2,
                             eps_depth_cap=1, olabel2=olab2)
        assert d2.emit_compact  # auto-on for the production shape


class TestHotColdSplit:
    """Hot/cold emit-table split (DeviceFst.hot_rows +
    BeamConfig.cold_expand_size): exact vs the single-table gather, with
    loud truncation when cold demand exceeds the lane budget."""

    def _setup(self):
        from catears_tpu.tools.biggraph import make_trie_graph, plant_logp
        rng = np.random.RandomState(21)
        g = make_trie_graph(rng, num_words=200, num_phones=25,
                            bigram_states=40, variants=2)
        logp, words = plant_logp(rng, g, 2, 100)
        return g, logp, words, rng

    def _decode(self, g, logp, hot_rows, cold, beam=256):
        import dataclasses

        from catears_tpu.decode.beam import decode_chunk, init_beam_batch
        from catears_tpu.decode.decoder import BatchDecoder
        from catears_tpu.graph.device import DeviceFst
        from catears_tpu.graph.transform import prepare_decode_graph

        cfg = BeamConfig(beam_size=beam, expand_size=4096,
                         eps_expand_size=2048, max_eps_iters=3,
                         cold_expand_size=cold)
        dec_fst, olab2, mode = prepare_decode_graph(g.fst)
        dfst = DeviceFst.build(dec_fst, g.tid2pdf, group=2,
                               eps_depth_cap=1 if mode != "raw" else None,
                               olabel2=olab2, hot_rows=hot_rows)
        dec = BatchDecoder(dec_fst, g.tid2pdf, config=cfg, dfst=dfst)
        return dec

    def test_split_matches_plain(self):
        import dataclasses

        from catears_tpu.graph.transform import hot_order, renumber_states

        g, logp, words, rng = self._setup()
        plain = self._decode(g, logp, 0, 0).decode(logp)
        # hot order from random counts; H covers half the states
        counts = rng.randint(0, 100, size=g.fst.num_states)
        h = g.fst.num_states // 2
        g2 = dataclasses.replace(
            g, fst=renumber_states(g.fst, hot_order(counts, h)))
        dec = self._decode(g2, logp, h, 256)  # cold cap = beam: safe
        got = dec.decode(logp, retry_on_overflow=False)
        for u in range(2):
            assert got[u].words == plain[u].words
            assert abs(got[u].weight - plain[u].weight) < 1e-3

    def test_cold_overflow_is_loud_and_retries(self):
        from catears_tpu.graph.transform import hot_order, renumber_states
        from catears_tpu.utils.errors import BeamCapacityError

        g, logp, words, rng = self._setup()
        plain = self._decode(g, logp, 0, 0).decode(logp)
        counts = rng.randint(0, 100, size=g.fst.num_states)
        h = 50  # tiny hot set: most tokens are cold
        import dataclasses
        g2 = dataclasses.replace(
            g, fst=renumber_states(g.fst, hot_order(counts, h)))
        dec = self._decode(g2, logp, h, 8)  # cold cap way too small
        with pytest.raises(BeamCapacityError) as ei:
            dec.decode(logp, retry_on_overflow=False)
        assert ei.value.hiwater[4] > 8
        # and the regrow-retry path recovers to the exact transcript
        got = dec.decode(logp)  # retry_on_overflow default True
        for u in range(2):
            assert got[u].words == plain[u].words


class TestAutosize:
    """One-call deployment geometry (decode.decoder.autosize): measured
    demand + margin replaces both the lm_dup_factor guess and the manual
    read-hiwater-export-env loop, on the trie + big-G' workload."""

    def _setup(self):
        from catears_tpu.tools.biggraph import (
            make_big_lm,
            make_trie_graph,
            plant_logp,
        )
        rng = np.random.RandomState(11)
        g = make_trie_graph(rng, num_words=150, num_phones=25,
                            bigram_states=30, variants=2)
        big = make_big_lm(rng, num_words=150)
        logp, words = plant_logp(rng, g, 1, 120)
        return g, big.delta_lm(), logp[0], words[0]

    def test_trie_with_lm(self):
        from catears_tpu.decode.decoder import autosize, decode_batch

        g, delta, logp, words = self._setup()
        cfg = autosize(g.fst, g.tid2pdf, logp, delta_lm=delta,
                       base=BeamConfig(beam_size=256), arc_group=2,
                       csr_group=8)
        # Tight geometry: bounded, decodes the same audio with no
        # truncation and no hand-tuning.
        assert cfg.lm_expand_size > 0
        hyps = decode_batch(g.fst, g.tid2pdf, logp[None], config=cfg,
                            delta_lm=delta, arc_group=2, csr_group=8)
        assert hyps[0].words[:len(words)] == words
        # ... and is genuinely tighter than the lm_dup_factor guess.
        from catears_tpu.decode.decoder import safe_config
        guess = safe_config(g.fst, 2, BeamConfig(beam_size=256), True,
                            csr_group=8)
        assert cfg.expand_size <= guess.expand_size

    def test_no_lm_exact_parity(self):
        from catears_tpu.decode.decoder import autosize, decode_batch

        g, _, logp, words = self._setup()
        cfg = autosize(g.fst, g.tid2pdf, logp,
                       base=BeamConfig(beam_size=256), arc_group=2)
        ref = decode_batch(g.fst, g.tid2pdf, logp[None], arc_group=2)
        got = decode_batch(g.fst, g.tid2pdf, logp[None], config=cfg,
                           arc_group=2)
        assert got[0].words == ref[0].words

    def test_margin_mismatch_never_silent(self):
        """Geometry sized on an EASY workload decoding a HARDER one (the
        deployment drift scenario): the result must
        either stay within margin (no overflow) or fail loudly — and the
        decode_batch runtime must recover via regrow-and-retry to the
        same transcript as an amply-sized decode.  Never a silently
        truncated hypothesis."""
        from catears_tpu.decode.decoder import autosize, decode_batch
        from catears_tpu.tools.biggraph import plant_logp
        from catears_tpu.utils.errors import BeamCapacityError

        g, _, logp_easy, _ = self._setup()
        # Harder: flatter acoustics (amp 4 vs the sizing run's 10) put
        # many more distinct states inside the beam per frame.
        rng = np.random.RandomState(77)
        logp_hard, _ = plant_logp(rng, g, 1, 120, amp=4.0)
        cfg = autosize(g.fst, g.tid2pdf, logp_easy,
                       base=BeamConfig(beam_size=256), arc_group=2)
        dec = Decoder(g.fst, g.tid2pdf, config=cfg, arc_group=2)
        dec.process(logp_hard[0])
        dec.end_of_stream()
        if dec.overflowed:
            with pytest.raises(BeamCapacityError):
                dec.best_path()
        # The runtime layer recovers either way.  Reference = the same
        # beam-256 search with never-truncate capacities, so the only
        # difference under test is the capacity geometry.
        from catears_tpu.decode.decoder import safe_config
        safe = safe_config(g.fst, 2, BeamConfig(beam_size=256), False)
        want = decode_batch(g.fst, g.tid2pdf, logp_hard, config=safe,
                            arc_group=2)
        got = decode_batch(g.fst, g.tid2pdf, logp_hard, config=cfg,
                           arc_group=2)
        assert got[0].words == want[0].words
