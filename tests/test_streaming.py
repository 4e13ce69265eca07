"""Fused streaming session equivalence tests.

The one-dispatch-per-chunk fused path must produce EXACTLY the same
transcript as the componentized FbankStream -> AMStream -> Decoder path on
real audio, across chunkings and odd utterance lengths.
"""

import os

import numpy as np
import pytest

from catears_tpu.decode.beam import BeamConfig
from catears_tpu.io.wav import read_pcm_header
from catears_tpu.runtime.recognizer import Recognizer, Utterance
from catears_tpu.tools.toy import write_toy_model

TEST_BEAM = BeamConfig(beam_size=256, expand_size=2048, eps_expand_size=1024,
                       max_eps_iters=6, beam=1e9, am_scale=0.1)


@pytest.fixture(scope="module")
def recognizer(tmp_path_factory):
    out = tmp_path_factory.mktemp("stream_model")
    write_toy_model(str(out), num_words=5, hidden=32, num_pdfs=24)
    return Recognizer(os.path.join(str(out), "toy.conf"),
                      beam_config=TEST_BEAM)


def decode_with(recognizer, wav_path, fused: bool, chunk_bytes: int = 1024,
                truncate: int = 0):
    with open(wav_path, "rb") as fd:
        fmt = read_pcm_header(fd)
        payload = fd.read()
    if truncate:
        payload = payload[:truncate]
    utt = Utterance(recognizer, fmt, fused=fused)
    for off in range(0, len(payload), chunk_bytes):
        utt.process(payload[off:off + chunk_bytes])
    utt.end_of_stream()
    return utt.hyp


class TestFusedStreaming:
    @pytest.mark.parametrize("wav", ["en-us-hello.wav", "en-us-cat.wav"])
    def test_fused_equals_componentized(self, recognizer, data_dir, wav):
        path = os.path.join(data_dir, wav)
        h_fused = decode_with(recognizer, path, fused=True)
        h_comp = decode_with(recognizer, path, fused=False)
        assert h_fused == h_comp
        assert len(h_fused) > 0

    def test_chunking_invariance(self, recognizer, data_dir):
        path = os.path.join(data_dir, "en-us-hello.wav")
        h1 = decode_with(recognizer, path, fused=True, chunk_bytes=1024)
        h2 = decode_with(recognizer, path, fused=True, chunk_bytes=517)
        h3 = decode_with(recognizer, path, fused=True, chunk_bytes=100000)
        assert h1 == h2 == h3

    @pytest.mark.parametrize("truncate", [500, 4000, 9001])
    def test_short_and_ragged_utterances(self, recognizer, data_dir,
                                         truncate):
        """EOS flush paths (never-started + mid-chunk) match componentized."""
        path = os.path.join(data_dir, "en-us-hello.wav")
        h_fused = decode_with(recognizer, path, fused=True,
                              truncate=truncate)
        h_comp = decode_with(recognizer, path, fused=False,
                             truncate=truncate)
        assert h_fused == h_comp

    def test_checkpoint_resume_fused(self, recognizer, data_dir):
        import pickle
        path = os.path.join(data_dir, "en-us-cat.wav")
        with open(path, "rb") as fd:
            fmt = read_pcm_header(fd)
            payload = fd.read()
        half = len(payload) // 2

        ref = Utterance(recognizer, fmt, fused=True)
        ref.process(payload)
        ref.end_of_stream()

        a = Utterance(recognizer, fmt, fused=True)
        a.process(payload[:half])
        blob = pickle.dumps(a.get_state())
        b = Utterance(recognizer, fmt, fused=True)
        b.set_state(pickle.loads(blob))
        b.process(payload[half:])
        b.end_of_stream()
        assert b.hyp == ref.hyp


class TestFusedCMVN:
    """Online CMVN inside the fused device program.

    The fused session carries the 600-frame CMVN ring on device in f32;
    the componentized path accumulates in f64 — transcripts must agree
    (feature deltas are ~1e-5 of the feature scale, far below any
    decision boundary on the toy model).
    """

    @pytest.fixture(scope="class")
    def cmvn_recognizer(self, tmp_path_factory, data_dir):
        import shutil
        out = tmp_path_factory.mktemp("stream_cmvn_model")
        write_toy_model(str(out), num_words=5, hidden=32, num_pdfs=24)
        shutil.copy(os.path.join(data_dir, "cmvn_stats.bin"),
                    os.path.join(str(out), "cmvn_stats.bin"))
        with open(os.path.join(str(out), "toy.conf"), "a") as fd:
            fd.write("cmvn_stats = cmvn_stats.bin\n")
        return Recognizer(os.path.join(str(out), "toy.conf"),
                          beam_config=TEST_BEAM)

    @pytest.mark.parametrize("wav", ["en-us-hello.wav", "en-us-cat.wav"])
    def test_fused_cmvn_equals_componentized(self, cmvn_recognizer,
                                             data_dir, wav):
        path = os.path.join(data_dir, wav)
        from catears_tpu.io.wav import WaveFormat
        utt = Utterance(cmvn_recognizer, WaveFormat(1, 16000, 16),
                        fused=True)
        assert utt.session is not None and utt.session.cmvn  # fused + CMVN
        h_fused = decode_with(cmvn_recognizer, path, fused=True)
        h_comp = decode_with(cmvn_recognizer, path, fused=False)
        assert h_fused == h_comp

    def test_fused_cmvn_features_match_host(self, cmvn_recognizer, data_dir):
        """Device ring-buffer CMVN == float64 OnlineCMVN to ~1e-4."""
        import jax.numpy as jnp
        from catears_tpu.frontend.cmvn import OnlineCMVN
        from catears_tpu.frontend.fbank import fbank_from_wave, num_frames
        from catears_tpu.io.wav import read_16k_pcm
        from catears_tpu.runtime.streaming import _device_cmvn_chunk

        samples = read_16k_pcm(os.path.join(data_dir, "en-us-hello.wav"))
        t = num_frames(samples.shape[0])
        feats = np.asarray(fbank_from_wave(jnp.asarray(samples), t))
        ref = OnlineCMVN(cmvn_recognizer.cmvn_stats).apply(feats)

        stats = np.asarray(cmvn_recognizer.cmvn_stats, np.float64)
        gsum = jnp.asarray(stats[:40], jnp.float32)
        gcount = jnp.float32(stats[40])
        ring = jnp.zeros((600, 40), jnp.float32)
        count = jnp.int32(0)
        outs = []
        for off in range(0, t, 20):  # 20-frame chunks like the session
            chunk = jnp.asarray(feats[off:off + 20])
            out, ring, count = _device_cmvn_chunk(gsum, gcount, ring,
                                                  count, chunk)
            outs.append(np.asarray(out))
        got = np.concatenate(outs)
        assert np.abs(got - ref).max() < 1e-3  # f32 ring vs f64 host


class TestBatchStreaming:
    """N concurrent streams in ONE fused program must
    equal N independent fused sessions — including ragged pacing where
    streams receive audio at different rates and finish at different
    times."""

    def _payload(self, data_dir, wav, truncate=0):
        path = os.path.join(data_dir, wav)
        with open(path, "rb") as fd:
            read_pcm_header(fd)
            payload = fd.read()
        return payload[:truncate] if truncate else payload

    def _pcm_to_f32(self, payload):
        return np.frombuffer(payload, dtype="<i2").astype(np.float32)

    def test_batch_equals_independent_sessions(self, recognizer, data_dir):
        payloads = [
            self._payload(data_dir, "en-us-hello.wav"),
            self._payload(data_dir, "en-us-cat.wav"),
            self._payload(data_dir, "en-us-hello.wav", truncate=9000),
        ]
        from catears_tpu.io.wav import WaveFormat
        # Reference: independent fused sessions
        want = []
        for p in payloads:
            utt = Utterance(recognizer, WaveFormat(1, 16000, 16),
                            fused=True)
            utt.process(p)
            utt.end_of_stream()
            want.append(utt.hyp)

        batch = recognizer.create_stream_batch(3)
        table = recognizer.symbol_table
        samples = [self._pcm_to_f32(p) for p in payloads]
        # Ragged pacing: different per-call chunk sizes per stream, and
        # stream 2 starts late.
        steps = [3000, 4700, 2400]
        offs = [0, 0, -20000]  # stream 2 gets nothing for a while
        done = [False] * 3
        while not all(done):
            for u in range(3):
                lo = offs[u]
                hi = lo + steps[u]
                offs[u] = hi
                if lo < 0:
                    continue  # not started yet
                chunk = samples[u][lo:hi]
                if lo >= samples[u].size:
                    if not done[u]:
                        batch.end_of_stream(u)
                        done[u] = True
                    continue
                batch.process(u, chunk)
        got = []
        for u in range(3):
            hyp = batch.best_path(u, end_of_stream=True)
            got.append(" ".join(table.get(w) for w in hyp.words))
        assert got == want

    def test_process_batch_one_group_step_per_tick(self, recognizer,
                                                   data_dir):
        """process_batch appends EVERY stream's chunk before draining, so
        simultaneous arrivals decode as ONE fused group step per tick —
        per-stream process() calls would drain between appends and
        serialize the same audio into B batch-1 steps (the bench's
        BENCH_STREAMS path relies on this).  Results must equal
        independent fused sessions."""
        from catears_tpu.io.wav import WaveFormat

        payload = self._payload(data_dir, "en-us-hello.wav")
        samples = self._pcm_to_f32(payload)
        want = []
        for _ in range(2):
            utt = Utterance(recognizer, WaveFormat(1, 16000, 16),
                            fused=True)
            utt.process(payload)
            utt.end_of_stream()
            want.append(utt.hyp)

        batch = recognizer.create_stream_batch(2)
        for off in range(0, samples.size, 3200):
            batch.process_batch([samples[off:off + 3200]] * 2)
        assert batch.num_frames_decoded[0] == batch.num_frames_decoded[1]
        # One _step_group per 20 decoded frames == both streams rode every
        # device step together (serialized steps would log 2 per 20).
        assert len(batch._dev_traces) == batch.num_frames_decoded[0] // 20
        table = recognizer.symbol_table
        got = []
        for u in range(2):
            batch.end_of_stream(u)
            hyp = batch.best_path(u, end_of_stream=True)
            got.append(" ".join(table.get(w) for w in hyp.words))
        assert got == want

    def test_partial_hypotheses_per_stream(self, recognizer, data_dir):
        """Mid-stream partials per stream match a solo session's partial
        at the same decoded-frame count."""
        payload = self._payload(data_dir, "en-us-cat.wav")
        samples = self._pcm_to_f32(payload)
        batch = recognizer.create_stream_batch(2)
        batch.process(0, samples[:24000])
        batch.process(1, samples[:8000])
        # partials() (one round trip for all streams) must equal the
        # per-stream best_path calls it replaces.
        all_hyps = batch.partials()
        assert [h.words for h in all_hyps] == [
            batch.best_path(u, end_of_stream=False).words for u in range(2)]
        solo = Utterance(recognizer,
                         __import__("catears_tpu.io.wav",
                                    fromlist=["WaveFormat"]
                                    ).WaveFormat(1, 16000, 16), fused=True)
        solo.process(payload[: 2 * 24000])
        assert (batch.num_frames_decoded[0]
                == solo.session.num_frames_decoded)
        got = batch.best_path(0, end_of_stream=False)
        want = solo.session.best_path(end_of_stream=False)
        assert got.words == want.words


class TestEdgeCases:
    def test_empty_audio(self, recognizer):
        """EOS with zero samples: empty transcript, no crash."""
        from catears_tpu.io.wav import WaveFormat
        utt = Utterance(recognizer, WaveFormat(1, 16000, 16), fused=True)
        utt.end_of_stream()
        assert utt.hyp == ""
        utt2 = Utterance(recognizer, WaveFormat(1, 16000, 16), fused=False)
        utt2.end_of_stream()
        assert utt2.hyp == ""

    def test_sub_frame_audio(self, recognizer):
        """Less than one fbank frame of audio: empty transcript."""
        from catears_tpu.io.wav import WaveFormat
        utt = Utterance(recognizer, WaveFormat(1, 16000, 16), fused=True)
        utt.process(b"\x00\x01" * 100)  # 100 samples < 400
        utt.end_of_stream()
        assert utt.hyp == ""

    def test_process_after_eos_is_noop(self, recognizer):
        from catears_tpu.io.wav import WaveFormat
        utt = Utterance(recognizer, WaveFormat(1, 16000, 16), fused=True)
        utt.process(b"\x00\x01" * 8000)
        utt.end_of_stream()
        hyp = utt.hyp
        utt.process(b"\x00\x01" * 8000)  # ignored after EOS
        assert utt.hyp == hyp


def test_streaming_trie_model_with_lm(tmp_path):
    """write_trie_model(with_lm=True) -> Recognizer: the fused streaming
    session decodes with on-the-fly delta-LM rescoring (the BENCH_STREAM_LM
    bench path), and the emitted large_lm/original_lm keys round-trip
    through the runtime loader (reference src/ce_stt.cc:82-110)."""
    import numpy as np

    from catears_tpu.io.wav import WaveFormat
    from catears_tpu.runtime.recognizer import Recognizer
    from catears_tpu.tools.biggraph import write_trie_model

    rng = np.random.RandomState(4)
    conf = write_trie_model(str(tmp_path), rng, num_words=80, hidden=32,
                            num_phones=25, bigram_states=20, variants=2,
                            with_lm=True)
    rec = Recognizer(conf)
    assert rec.delta_lm is not None
    utt = rec.create_utterance(WaveFormat(1, 16000, 16))
    pcm = (rng.randn(16000) * 1000).astype("<i2").tobytes()
    for off in range(0, len(pcm), 1024):
        utt.process(pcm[off:off + 1024])
    utt.end_of_stream()
    assert isinstance(utt.hyp, str)  # decoded without capacity errors


def test_incremental_backtracker_matches_full_walk():
    """IncrementalBacktracker must equal the naive full backtrace at every
    refresh, across random growing traces, path switches, and rooted
    chains (prev_slot -1)."""
    import numpy as np

    from catears_tpu.decode.hyp import (
        HostTrace,
        IncrementalBacktracker,
        backtrace,
    )

    rng = np.random.RandomState(0)
    k, w = 16, 3
    for trial in range(5):
        tracker = IncrementalBacktracker()
        traces = []
        # init pseudo-frame: every chain roots here
        traces.append(HostTrace(np.full(k, -1, np.int32),
                                np.zeros((k, w), np.int32)))
        for step in range(40):
            prev = rng.randint(0, k, size=k).astype(np.int32)
            if rng.rand() < 0.1:
                # occasional rooted rows (frozen/dead-frame convention)
                prev[rng.randint(0, k)] = -1
            words = np.where(rng.rand(k, w) < 0.3,
                             rng.randint(1, 50, size=(k, w)), 0)
            traces.append(HostTrace(prev, words.astype(np.int32)))
            if step % 3 == 0:
                slot = int(rng.randint(0, k))
                got = tracker.best_words(traces, slot)
                want = backtrace(traces, slot)
                assert got == want, (trial, step, slot)
