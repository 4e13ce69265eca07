"""Graph layer tests: LmFst backoff walks and DeltaLmFst rescoring.

Golden sentence scores mirror reference test/fst_test.cc:153-210 (computed on
the same G.pfst / lm.words.txt / lm.1order.bin fixtures).
"""

import os

import numpy as np
import pytest

from catears_tpu.io.binfmt import read_vec0_file
from catears_tpu.graph.fst import DeltaLmFst, FlatFst, LmFst
from catears_tpu.io.symbols import SymbolTable


@pytest.fixture(scope="module")
def lm_fst(data_dir):
    return LmFst.read_lm(os.path.join(data_dir, "G.pfst"))


@pytest.fixture(scope="module")
def symbols(data_dir):
    return SymbolTable.read(os.path.join(data_dir, "lm.words.txt"))


def lm_score(lm: LmFst, table: SymbolTable, query: str) -> float:
    """Sentence log-prob via BOS + words + EOS + final, as in the reference."""
    state = lm.start
    score = 0.0
    hit = lm.get_arc_backoff(state, table.bos_id)
    assert hit is not None
    state, w = hit
    score += w
    for word in query.split():
        wid = table.get_id(word)
        assert wid != -1, word
        hit = lm.get_arc_backoff(state, wid)
        assert hit is not None, word
        state, w = hit
        score += w
    hit = lm.get_arc_backoff(state, table.eos_id)
    assert hit is not None
    state, w = hit
    score += w
    score += lm.final_backoff(state)
    return -score


def delta_lm_score(delta: DeltaLmFst, table: SymbolTable, query: str) -> float:
    state = delta.start_state()
    score = 0.0
    for word in query.split():
        wid = table.get_id(word)
        hit = delta.get_arc(state, wid)
        assert hit is not None, word
        state, w = hit
        score += w
    return score + delta.final(state)


GOLDEN_LM = [
    (-38.767048, "marisa runs the kirisame magic shop"),
    (-28.481011, "reimu and marisa are friends"),
    (-62.663559, "reimu and marisa are playable characters in the games of touhou"),
    (-6.2797366, "marisa"),
]

GOLDEN_DELTA = [
    (0.886695, "marisa runs the kirisame magic shop"),
    (-1.433023, "reimu and marisa are friends"),
    (-0.688201, "reimu and marisa are playable characters in the games of touhou"),
    (-0.510554, "marisa"),
]


class TestLmFst:
    @pytest.mark.parametrize("expected,query", GOLDEN_LM)
    def test_sentence_scores(self, lm_fst, symbols, expected, query):
        assert abs(lm_score(lm_fst, symbols, query) - expected) < 1e-4

    def test_backoff_miss_returns_none(self, lm_fst):
        # ilabel far beyond vocab: no arc anywhere along the backoff chain
        assert lm_fst.get_arc_backoff(lm_fst.start, 10**6) is None


class TestDeltaLmFst:
    @pytest.mark.parametrize("expected,query", GOLDEN_DELTA)
    def test_delta_scores(self, data_dir, lm_fst, symbols, expected, query):
        small_lm = read_vec0_file(os.path.join(data_dir, "lm.1order.bin"))
        delta = DeltaLmFst(small_lm, lm_fst, symbols)
        assert abs(delta_lm_score(delta, symbols, query) - expected) < 1e-4


class TestFlatFstConversions:
    def test_const_fst_matches_pkfst(self, data_dir):
        """The same graph through both loaders must behave identically."""
        pk = FlatFst.read(os.path.join(data_dir, "G.pfst"))
        # Re-export as ConstFst and reload
        import io as _io

        from catears_tpu.io.openfst import ConstFst, read_const_fst, write_const_fst
        counts = np.diff(pk.offsets).astype(np.int32)
        cf = ConstFst(start=pk.start, final=pk.final,
                      arc_pos=pk.offsets[:-1].astype(np.int64),
                      arc_count=counts, arc_ilabel=pk.arc_ilabel,
                      arc_olabel=pk.arc_olabel, arc_weight=pk.arc_weight,
                      arc_next=pk.arc_next)
        buf = _io.BytesIO()
        write_const_fst(buf, cf)
        buf.seek(0)
        back = FlatFst.from_const_fst(read_const_fst(buf))
        assert back.start == pk.start
        np.testing.assert_array_equal(back.final, pk.final)
        np.testing.assert_array_equal(back.offsets, pk.offsets)
        np.testing.assert_array_equal(back.arc_ilabel, pk.arc_ilabel)
        np.testing.assert_array_equal(back.arc_next, pk.arc_next)


class TestCloseEpsilons:
    """graph.transform.close_epsilons: exact depth-1 closure."""

    def test_trie_parity_one_round(self):
        from catears_tpu.decode.oracle import OracleDecoder
        from catears_tpu.graph.transform import close_epsilons
        from catears_tpu.tools.biggraph import make_trie_graph, plant_logp

        rng = np.random.RandomState(1)
        g = make_trie_graph(rng, num_words=150, num_phones=30,
                            bigram_states=40, variants=2)
        closed, ok = close_epsilons(g.fst)
        assert ok
        logp, _ = plant_logp(rng, g, 1, 120)
        hyps = []
        for fst, iters in ((g.fst, 6), (closed, 1)):
            o = OracleDecoder(fst, g.tid2pdf, am_scale=0.1, beam=12.0,
                              beam_size=256, max_eps_iters=iters)
            for row in logp[0]:
                o.process(row)
            hyps.append(o.best_path(end_of_stream=True))
        assert hyps[0].words == hyps[1].words
        assert abs(hyps[0].weight - hyps[1].weight) < 1e-4

    def test_multi_olabel_chain_bails(self):
        from catears_tpu.graph.transform import close_epsilons

        # 0 -eps:olabel1-> 1 -eps:olabel2-> 2 : inexpressible as one arc
        fst = FlatFst.from_arrays(
            0, np.array([np.inf, np.inf, 0.0], np.float32),
            state_of_arc=np.array([0, 1]), arc_next=np.array([1, 2]),
            arc_ilabel=np.array([0, 0]), arc_olabel=np.array([1, 2]),
            arc_weight=np.array([0.5, 0.5], np.float32))
        out, ok = close_epsilons(fst)
        assert not ok and out is fst

    def test_eps_cycle_converges(self):
        from catears_tpu.graph.transform import close_epsilons

        # positive-weight eps 3-cycle: closure = simple paths, converges
        fst = FlatFst.from_arrays(
            0, np.array([0.0, np.inf, np.inf], np.float32),
            state_of_arc=np.array([0, 1, 2]), arc_next=np.array([1, 2, 0]),
            arc_ilabel=np.array([0, 0, 0]), arc_olabel=np.array([0, 0, 0]),
            arc_weight=np.array([0.5, 0.25, 0.125], np.float32))
        out, ok = close_epsilons(fst)
        assert ok
        # state 0 reaches 1, 2 and itself (full cycle) directly
        lo, hi = out.arc_range(0)
        dsts = sorted(out.arc_next[lo:hi].tolist())
        assert dsts == [0, 1, 2]

    def test_eps_free_graph_unchanged(self):
        from catears_tpu.graph.transform import close_epsilons

        fst = FlatFst.from_arrays(
            0, np.array([0.0, 0.0], np.float32),
            state_of_arc=np.array([0]), arc_next=np.array([1]),
            arc_ilabel=np.array([3]), arc_olabel=np.array([0]),
            arc_weight=np.array([0.5], np.float32))
        out, ok = close_epsilons(fst)
        assert ok and out is fst


class TestRenumber:
    """State renumbering (decode-locality layouts) must be an exact
    relabeling: identical transcripts and weights on any order."""

    def test_bfs_and_freq_orders_decode_identically(self):
        from catears_tpu.decode.decoder import decode_batch
        from catears_tpu.graph.transform import (
            bfs_order,
            frequency_order,
            renumber_states,
        )
        from catears_tpu.tools.biggraph import make_trie_graph, plant_logp

        rng = np.random.RandomState(3)
        g = make_trie_graph(rng, num_words=120, num_phones=20,
                            bigram_states=25, variants=2)
        logp, words = plant_logp(rng, g, 2, 100)
        from catears_tpu.decode.beam import BeamConfig
        cfg = BeamConfig(beam_size=256, expand_size=4096,
                         eps_expand_size=2048, max_eps_iters=3)
        want = decode_batch(g.fst, g.tid2pdf, logp, config=cfg,
                            arc_group=2)
        perms = [bfs_order(g.fst),
                 frequency_order(
                     rng.randint(0, 50, size=g.fst.num_states))]
        for perm in perms:
            assert np.array_equal(np.sort(perm),
                                  np.arange(g.fst.num_states))
            f2 = renumber_states(g.fst, perm)
            got = decode_batch(f2, g.tid2pdf, logp, config=cfg,
                               arc_group=2)
            for u in range(2):
                assert got[u].words == want[u].words
                assert abs(got[u].weight - want[u].weight) < 1e-3

    def test_bfs_order_starts_at_start(self):
        from catears_tpu.graph.transform import bfs_order
        from catears_tpu.tools.toy import make_phone_loop_graph
        from catears_tpu.graph.fst import FlatFst

        rng = np.random.RandomState(0)
        graph = make_phone_loop_graph(rng, num_words=5, num_pdfs=24)
        fst = FlatFst.from_raw(graph.fst)
        perm = bfs_order(fst)
        assert perm[fst.start] == 0


class TestBigLmDevice:
    """ARPA-scale G' stress: device lm_propagate vs the host backoff walk.

    The toy G.pfst has hundreds of states; this exercises the
    dense state-0 fast path and 2-hop trigram backoff chains at a ~100k
    state / 2k vocab shape (scaled down from the 50k-vocab bench geometry,
    same structure).
    """

    @pytest.fixture(scope="class")
    def big(self):
        from catears_tpu.tools.biggraph import make_big_lm
        return make_big_lm(np.random.RandomState(7), num_words=2000)

    def test_shape(self, big):
        assert big.num_states >= 2 * 2000
        # state 0 is vocab-sized (the dense-table case)
        assert int(big.lm.offsets[1] - big.lm.offsets[0]) == 2002

    def test_propagate_parity(self, big):
        import jax.numpy as jnp
        from catears_tpu.graph.device import DeviceLm, lm_propagate

        delta = big.delta_lm()
        dlm = DeviceLm.build(delta)
        rng = np.random.RandomState(3)
        n = 512
        # Mix of state kinds: unigram 0, bigram histories, trigram states,
        # post-BOS; labels biased to frequent words + some misses.
        states = np.concatenate([
            np.zeros(64, np.int64),
            rng.randint(1, 2001, size=256),
            rng.randint(2003, big.num_states, size=128),
            np.full(64, 2001),
        ])[:n].astype(np.int32)
        labels = np.where(rng.rand(n) < 0.7,
                          1 + (rng.pareto(1.0, n) * 40).astype(np.int64),
                          rng.randint(0, 2003, size=n)).astype(np.int32)
        labels = np.minimum(labels, 2002)
        out_s, out_w = lm_propagate(dlm, jnp.asarray(states),
                                    jnp.asarray(labels))
        out_s, out_w = np.asarray(out_s), np.asarray(out_w)
        for i in range(n):
            s, l = int(states[i]), int(labels[i])
            if l == 0:
                exp_s, exp_w = s, 0.0
            else:
                hit = delta.get_arc(s, l)
                exp_s, exp_w = (s, 0.0) if hit is None else hit
            assert out_s[i] == exp_s, (i, s, l)
            np.testing.assert_allclose(out_w[i], exp_w, atol=1e-5,
                                       err_msg=str((i, s, l)))

    def test_dense_table_matches_span(self, big):
        from catears_tpu.graph.device import DeviceLm

        dlm = DeviceLm.build(big.delta_lm())
        lo, hi = int(big.lm.offsets[0]), int(big.lm.offsets[1])
        uni_next = np.asarray(dlm.uni_next)
        uni_w = np.asarray(dlm.uni_weight)
        for pos in range(lo, hi):
            lab = int(big.lm.arc_ilabel[pos])
            assert uni_next[lab] == int(big.lm.arc_next[pos])
            np.testing.assert_allclose(uni_w[lab],
                                       float(big.lm.arc_weight[pos]))
        # Every non-state-0 (state, ilabel>0) arc must be findable in the
        # two-choice hash (first bucket, or second when the first carries
        # the overflow bit) — the invariant the device walk relies on.
        from catears_tpu.graph.device import _lm_hash
        tab = np.asarray(dlm.hash_tab)
        state_of_arc = np.repeat(np.arange(big.lm.num_states),
                                 np.diff(big.lm.offsets))
        sel = (big.lm.arc_ilabel > 0) & (state_of_arc != 0)
        ks = state_of_arc[sel].astype(np.int32)
        kl = big.lm.arc_ilabel[sel].astype(np.int32)
        kn = big.lm.arc_next[sel]
        h1 = _lm_hash(np, ks, kl, dlm.hash_seed1, dlm.hash_mask)
        h2 = _lm_hash(np, ks, kl, dlm.hash_seed2, dlm.hash_mask)
        for i in range(0, ks.size, 17):  # sampled sweep
            found = None
            for h in (h1[i], h2[i]):
                row = tab[h]
                for slot in range(4):
                    lab = row[4 + slot] & 0x7FFFFFFF
                    if row[slot] == ks[i] and lab == kl[i]:
                        found = row[8 + slot]
                if found is not None:
                    break
            assert found == kn[i], (ks[i], kl[i])


class TestLmHashBuild:
    def test_stress_all_keys_findable(self):
        """100k random (state, label) keys: every key resolves via the
        two-choice probe protocol (first bucket, second only when the
        overflow bit says so), and misses are definitive."""
        import numpy as np

        from catears_tpu.graph.device import DeviceLm, _lm_hash

        rng = np.random.RandomState(0)
        n = 100_000
        ks = rng.randint(1, 50_000, size=n).astype(np.int32)
        kl = rng.randint(1, 30_000, size=n).astype(np.int32)
        uniq = np.unique(ks.astype(np.int64) * 30_000 + kl)
        ks = (uniq // 30_000).astype(np.int32)
        kl = (uniq % 30_000).astype(np.int32)
        kn = np.arange(ks.size, dtype=np.int32)
        kw = rng.randn(ks.size).astype(np.float32).view(np.int32)
        tab, s1, s2, mask = DeviceLm._build_hash(ks, kl, kn, kw)

        def lookup(s, l):
            for phase, seed in ((0, s1), (1, s2)):
                b = int(_lm_hash(np, np.array([s]), np.array([l]),
                                 seed, mask)[0])
                row = tab[b]
                ov = row[4] < 0
                for slot in range(4):
                    lab = row[4 + slot] & 0x7FFFFFFF
                    if row[slot] == s and lab == l:
                        return row[8 + slot]
                if phase == 0 and not ov:
                    return None  # definitive miss, no second probe
            return None

        idx = rng.choice(ks.size, size=4000, replace=False)
        for i in idx:
            assert lookup(int(ks[i]), int(kl[i])) == kn[i]
        # and misses stay misses
        for _ in range(200):
            s, l = int(rng.randint(1, 50_000)), int(rng.randint(30_001,
                                                                40_000))
            assert lookup(s, l) is None

    def test_unigram_only_lm_builds_empty_hash(self):
        """A G' whose arcs all live on state 0 (pure unigram LM) hashes
        zero keys; the build must produce a valid empty table instead of
        crashing, and lookups must resolve from the dense state-0 path
        (round-4 advisor finding)."""
        import types

        import jax.numpy as jnp

        from catears_tpu.graph.device import DeviceLm, lm_propagate
        from catears_tpu.graph.fst import DeltaLmFst, LmFst

        # state 0 only: <s>=1, </s>=2, words 3..6 all loop on state 0.
        labels = np.arange(1, 7, dtype=np.int32)
        weights = np.linspace(0.5, 3.0, 6).astype(np.float32)
        lm = LmFst.from_arrays(
            start=0, final=np.zeros(1, np.float32),
            state_of_arc=np.zeros(6, np.int64), arc_next=np.zeros(6),
            arc_ilabel=labels, arc_olabel=labels, arc_weight=weights)
        small = np.zeros(7, np.float32)
        delta = DeltaLmFst(small, lm,
                           types.SimpleNamespace(bos_id=1, eos_id=2))
        dlm = DeviceLm.build(delta)  # must not raise
        qs = jnp.zeros(8, jnp.int32)
        ql = jnp.asarray([0, 1, 2, 3, 4, 5, 6, 6], jnp.int32)
        out_s, out_w = lm_propagate(dlm, qs, ql)
        for i in range(8):
            lab = int(ql[i])
            if lab == 0:
                exp = (0, 0.0)
            else:
                exp = delta.get_arc(0, lab)
            assert int(out_s[i]) == exp[0]
            np.testing.assert_allclose(float(out_w[i]), exp[1], atol=1e-6)
