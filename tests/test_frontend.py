"""Frontend tests: fbank golden parity vs Kaldi and streaming equivalence.

Mirrors reference test/fbank_test.cc: batch fbank output must match the
golden Kaldi dump (fbankmat_en-us-hello.wav.txt, 1880 values) to 1e-4, and
feeding the same audio in 1024-byte chunks must give identical features.
Also checks online CMVN parity vs the Kaldi CMVN golden dump.
"""

import os

import numpy as np
import pytest

from catears_tpu.frontend.cmvn import CMVNStream, OnlineCMVN
from catears_tpu.frontend.fbank import Fbank, FbankStream, num_frames
from catears_tpu.io.binfmt import read_vec0_file
from catears_tpu.io.wav import read_16k_pcm


def load_golden(path: str, cols: int = 40) -> np.ndarray:
    values = np.loadtxt(path, dtype=np.float64)
    assert values.size % cols == 0
    return values.reshape(-1, cols)


class TestFbankGoldenParity:
    def test_batch_matches_kaldi(self, data_dir):
        wave = read_16k_pcm(os.path.join(data_dir, "en-us-hello.wav"))
        golden = load_golden(os.path.join(data_dir,
                                          "fbankmat_en-us-hello.wav.txt"))
        feats = Fbank().compute(wave)
        assert feats.shape == golden.shape
        err = np.abs(feats - golden).max()
        assert err < 1e-4, f"max abs err {err}"

    def test_frame_count_snip_edges(self):
        assert num_frames(399) == 0
        assert num_frames(400) == 1
        assert num_frames(559) == 1
        assert num_frames(560) == 2
        assert num_frames(16000) == 98

    def test_streaming_equals_batch(self, data_dir):
        """1024-byte chunk feeding (reference test/fbank_test.cc:85-136)."""
        path = os.path.join(data_dir, "en-us-hello.wav")
        wave = read_16k_pcm(path)
        batch = Fbank().compute(wave)

        stream = FbankStream()
        chunks = []
        samples_per_chunk = 512  # 1024 bytes of 16-bit samples
        for off in range(0, wave.size, samples_per_chunk):
            chunks.append(stream.process(wave[off:off + samples_per_chunk]))
        streamed = np.concatenate(chunks)
        assert streamed.shape == batch.shape
        np.testing.assert_allclose(streamed, batch, atol=1e-4)

    def test_empty_and_short_input(self):
        stream = FbankStream()
        out = stream.process(np.zeros(0, np.float32))
        assert out.shape == (0, 40)
        out = stream.process(np.zeros(399, np.float32))
        assert out.shape == (0, 40)
        out = stream.process(np.zeros(1, np.float32))
        assert out.shape == (1, 40)


class TestCMVN:
    def test_golden_parity(self, data_dir):
        """fbank+CMVN vs Kaldi's apply-cmvn-online golden dump."""
        wave = read_16k_pcm(os.path.join(data_dir, "en-us-hello.wav"))
        golden = load_golden(
            os.path.join(data_dir, "fbankcmvnmat_en-us-hello.wav.txt"))
        stats = read_vec0_file(os.path.join(data_dir, "cmvn_stats.bin"))
        feats = Fbank().compute(wave)
        normed = OnlineCMVN(stats).apply(feats)
        assert normed.shape == golden.shape
        err = np.abs(normed - golden).max()
        assert err < 1e-3, f"max abs err {err}"

    def test_streaming_equals_batch(self, data_dir):
        rng = np.random.RandomState(0)
        feats = rng.randn(700, 40).astype(np.float32) * 3 + 10
        stats = np.concatenate([rng.rand(40) * 1e6, [1e5]]).astype(np.float32)
        batch = OnlineCMVN(stats).apply(feats)
        stream = CMVNStream(stats)
        parts = [stream.process(feats[i:i + 17]) for i in range(0, 700, 17)]
        np.testing.assert_allclose(np.concatenate(parts), batch, atol=1e-5)


class TestDftBasis:
    def test_dft_matrix_matches_rfft(self):
        """The matmul DFT basis == numpy rfft on zero-padded frames.

        This is the srfft_test analogue: the reference validates its
        split-radix FFT against golden outputs; here the DFT-as-matmul
        formulation must match a trusted FFT to float32 precision.
        """
        from catears_tpu.frontend.fbank import _constants, FRAME_LENGTH

        rng = np.random.RandomState(0)
        _, dft, _ = _constants()
        x = rng.randn(5, FRAME_LENGTH).astype(np.float32)
        spec = x @ dft
        re, im = spec[:, :257], spec[:, 257:]
        padded = np.zeros((5, 512))
        padded[:, :FRAME_LENGTH] = x
        ref = np.fft.rfft(padded, axis=1)
        np.testing.assert_allclose(re, ref.real, atol=2e-3)
        np.testing.assert_allclose(im, ref.imag, atol=2e-3)
        # Power spectra agree to float32 relative precision
        p1 = re * re + im * im
        p2 = np.abs(ref) ** 2
        np.testing.assert_allclose(p1, p2, rtol=1e-4, atol=1e-3)

