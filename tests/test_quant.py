"""Int8 quantized GEMM and AM tests (reference test/gemm_test.cc pattern).

Randomized differential: the s8 x s8 -> s32 matmul with dequant epilogue vs
the float matmul, accuracy criterion max_error / result_range < 1%
(reference test/gemm_test.cc:120).  The s8 matmul itself must equal the
exact integer product.  The same checks run on the card in the `gpu`-marked
test (and in chip_smoke.py's AM phase at full width).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from catears_tpu.am.model import AcousticModel
from catears_tpu.am.nnet import build_nnet, nnet_forward
from catears_tpu.am.quant import (
    nnet_forward_quant,
    qmatmul,
    quantize,
    matmul_s8,
    quantize_params,
)
from catears_tpu.io.config import Configuration
from catears_tpu.tools.toy import make_toy_nnet, write_toy_model


def relative_error(ref: np.ndarray, got: np.ndarray) -> float:
    rng = ref.max() - ref.min()
    return float(np.abs(ref - got).max() / max(rng, 1e-9))


class TestQuantize:
    def test_roundtrip_accuracy(self):
        rng = np.random.RandomState(0)
        x = rng.randn(64, 48).astype(np.float32) * 3
        q = quantize(jnp.asarray(x))
        deq = (np.asarray(q.values, np.int32) + 128
               - int(q.zero_point)) * float(q.scale)
        # one quantization step of error max
        assert np.abs(deq - x).max() <= float(q.scale) * 0.51 + 1e-6

    def test_constant_matrix(self):
        q = quantize(jnp.full((8, 8), 2.5))
        deq = (np.asarray(q.values, np.int32) + 128
               - int(q.zero_point)) * float(q.scale)
        assert np.abs(deq - 2.5).max() < 1e-5


class TestQuantMatmul:
    @pytest.mark.parametrize("shape", [(8, 16, 8), (30, 20, 10),
                                       (100, 200, 300), (129, 65, 257)])
    def test_vs_float(self, shape):
        m, k, n = shape
        rng = np.random.RandomState(sum(shape))
        a = rng.randn(m, k).astype(np.float32)
        b = (rng.randn(k, n).astype(np.float32) * 2 + 0.5)
        ref = a @ b
        got = np.asarray(qmatmul(quantize(jnp.asarray(a)),
                                 quantize(jnp.asarray(b))))
        err = relative_error(ref, got)
        assert err < 0.01, f"relative error {err}"


class TestQuantizedAM:
    def test_quant_nnet_close_to_float(self):
        rng = np.random.RandomState(3)
        spec = make_toy_nnet(rng, hidden=64, num_pdfs=32)
        nnet_def, params = build_nnet(spec)
        qparams = quantize_params(nnet_def, params)
        x = jnp.asarray(rng.randn(20, 40).astype(np.float32))
        ref = np.asarray(nnet_forward(nnet_def, params, x))
        got = np.asarray(nnet_forward_quant(nnet_def, qparams, x))
        assert got.shape == ref.shape
        # log-softmax outputs: compare probabilities
        assert np.abs(np.exp(got) - np.exp(ref)).max() < 0.05

    def test_config_wiring(self, tmp_path):
        """`quantized = true` activates the int8 path end to end."""
        write_toy_model(str(tmp_path), hidden=32, num_pdfs=24)
        with open(tmp_path / "toy.conf", "a") as fd:
            fd.write("quantized = true\n")
        conf = Configuration.read(str(tmp_path / "toy.conf"))
        am = AcousticModel.read(conf)
        assert am.quantized
        feats = np.random.RandomState(4).randn(30, 40).astype(np.float32)
        out = am.forward(feats)
        assert out.shape == (30, 24)
        am_f = AcousticModel(am.nnet_def, am.float_params,
                             np.asarray(am.log_prior), am.tid2pdf,
                             am.left_context, am.right_context,
                             am.chunk_size, am.num_pdfs, quantized=False)
        ref = am_f.forward(feats)
        assert np.abs(np.exp(out + np.log(1 / 24))
                      - np.exp(ref + np.log(1 / 24))).max() < 0.05


def _exact_s8_check(m, k, n, seed):
    rng = np.random.RandomState(seed)
    a = rng.randint(-128, 128, size=(m, k)).astype(np.int8)
    b = rng.randint(-128, 128, size=(k, n)).astype(np.int8)
    a[0, :] = -128  # the extreme products accumulate exactly too
    b[:, 0] = -128
    got = np.asarray(jax.jit(matmul_s8)(a, b))
    assert got.dtype == np.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(
        got, a.astype(np.int64) @ b.astype(np.int64))


class TestMatmulS8:
    @pytest.mark.parametrize("shape", [(1, 1, 1), (7, 5, 3), (33, 130, 17),
                                       (129, 65, 257), (16, 3072, 6)])
    def test_exact_vs_integer_numpy(self, shape):
        """Odd shapes, K and N not multiples of 4, long K reductions."""
        _exact_s8_check(*shape, seed=sum(shape))

    @pytest.mark.gpu
    def test_on_gpu(self):
        """The s8 GEMM and the 1%-of-range criterion on the card."""
        if jax.default_backend() != "gpu":
            pytest.skip("no GPU: JAX's default backend is "
                        f"{jax.default_backend()!r}")
        _exact_s8_check(1000, 3072, 1024, seed=0)
        rng = np.random.RandomState(0)
        a = rng.randn(100, 200).astype(np.float32)
        b = rng.randn(200, 300).astype(np.float32) * 2 + 0.5
        got = np.asarray(qmatmul(quantize(jnp.asarray(a)),
                                 quantize(jnp.asarray(b))))
        assert relative_error(a.astype(np.float64) @ b, got) < 0.01


class TestCalibratedQuant:
    def test_static_matches_dynamic_semantics(self):
        """quantize_static(x, min(x), max(x)) == quantize(x) exactly."""
        from catears_tpu.am.quant import quantize_static
        rng = np.random.RandomState(11)
        x = jnp.asarray(rng.randn(40, 24).astype(np.float32) * 3)
        dyn = quantize(x)
        st = quantize_static(x, float(x.min()), float(x.max()))
        np.testing.assert_array_equal(np.asarray(dyn.values),
                                      np.asarray(st.values))
        np.testing.assert_allclose(float(dyn.scale), float(st.scale))
        assert int(dyn.zero_point) == int(st.zero_point)

    def test_calibrated_nnet_accuracy(self):
        """Calibrated int8 stack stays within the 1%-of-range criterion
        on held-out data (out-of-range activations saturate)."""
        from catears_tpu.am.quant import calibrate_ranges
        rng = np.random.RandomState(5)
        spec = make_toy_nnet(rng, hidden=64, num_pdfs=32)
        nnet_def, params = build_nnet(spec)
        qparams = quantize_params(nnet_def, params)
        calib = jnp.asarray(rng.randn(50, 40).astype(np.float32))
        calibrate_ranges(nnet_def, params, qparams, calib)
        assert any("rng" in p for p in qparams if isinstance(p, dict))
        x = jnp.asarray(rng.randn(20, 40).astype(np.float32))  # held-out
        ref = np.asarray(nnet_forward(nnet_def, params, x))
        got = np.asarray(nnet_forward_quant(nnet_def, qparams, x))
        assert np.abs(np.exp(got) - np.exp(ref)).max() < 0.05

    def test_multi_utterance_calibration(self):
        """Ranges cover the min/max across ALL calibration utterances."""
        from catears_tpu.am.quant import calibrate_ranges
        rng = np.random.RandomState(7)
        spec = make_toy_nnet(rng, hidden=32, num_pdfs=24)
        nnet_def, params = build_nnet(spec)
        q1 = quantize_params(nnet_def, params)
        q2 = quantize_params(nnet_def, params)
        quiet = rng.randn(30, 40).astype(np.float32) * 0.5
        loud = rng.randn(30, 40).astype(np.float32) * 4.0
        calibrate_ranges(nnet_def, params, q1, [quiet, loud])
        calibrate_ranges(nnet_def, params, q2, quiet)
        for p1, p2 in zip(q1, q2):
            if isinstance(p1, dict) and "rng" in p1:
                assert p1["rng"][0] <= p2["rng"][0]
                assert p1["rng"][1] >= p2["rng"][1]

    def test_out_of_range_saturation_and_guard(self):
        """Held-out activations far outside the calibrated range: the
        unguarded static path saturates (bounded error documented by
        calibration_coverage), the guarded path falls back to dynamic
        quantization and stays within the 1%-of-range criterion."""
        from catears_tpu.am.quant import (
            calibrate_ranges,
            calibration_coverage,
        )
        rng = np.random.RandomState(8)
        spec = make_toy_nnet(rng, hidden=64, num_pdfs=32)
        nnet_def, params = build_nnet(spec)
        calib = rng.randn(50, 40).astype(np.float32)  # unit-scale data
        hot = jnp.asarray(rng.randn(20, 40).astype(np.float32) * 5)  # 5x

        q_guard = quantize_params(nnet_def, params)
        calibrate_ranges(nnet_def, params, q_guard, calib, guard=True)
        assert any("grng" in p for p in q_guard if isinstance(p, dict))
        cov = calibration_coverage(nnet_def, params, q_guard, hot)
        assert cov[0] < 1.0  # the held-out data really is out of range
        ref = np.asarray(nnet_forward(nnet_def, params, hot))
        got = np.asarray(nnet_forward_quant(nnet_def, q_guard, hot))
        assert np.abs(np.exp(got) - np.exp(ref)).max() < 0.05

        # Unguarded saturating path on the same data: error may exceed the
        # guarded path's (document, don't assert tightness) but the result
        # must stay finite and shaped.
        q_sat = quantize_params(nnet_def, params)
        calibrate_ranges(nnet_def, params, q_sat, calib, guard=False)
        sat = np.asarray(nnet_forward_quant(nnet_def, q_sat, hot))
        assert np.isfinite(sat).all()

    def test_calibrate_via_model(self):
        from catears_tpu.am.model import AcousticModel
        rng = np.random.RandomState(6)
        spec = make_toy_nnet(rng, hidden=32, num_pdfs=24)
        nnet_def, params = build_nnet(spec)
        prior = np.full(24, 1 / 24, np.float32)
        am = AcousticModel(nnet_def, params, np.log(prior),
                           np.arange(49, dtype=np.int32) // 2,
                           left_context=16, right_context=9, chunk_size=20,
                           num_pdfs=24, quantized=True)
        feats = rng.randn(40, 40).astype(np.float32)
        out_dyn = am.forward(feats)
        am.calibrate(am.pad_context(feats))
        out_cal = am.forward(feats)
        assert np.abs(np.exp(out_cal + np.log(1 / 24))
                      - np.exp(out_dyn + np.log(1 / 24))).max() < 0.05


class TestGuardTranscript:
    def test_guarded_int8_decode_matches_float_transcript(self, tmp_path,
                                                          data_dir):
        """Transcript-level guard-mode check: the full Recognizer pipeline
        with a guard-calibrated int8 AM must transcribe real audio the
        same as the float AM (int8 error is bounded at 1% of range, far
        inside the toy decode's margins; the guard falls back to exact
        dynamic quantization on any out-of-calibration input)."""
        import os

        import numpy as np

        from catears_tpu.frontend.fbank import fbank_from_wave, num_frames
        from catears_tpu.io.wav import read_16k_pcm
        from catears_tpu.runtime.recognizer import Recognizer, \
            decode_wav_file
        from catears_tpu.tools.toy import write_toy_model

        conf = write_toy_model(str(tmp_path), rng=np.random.RandomState(6),
                               num_words=20, hidden=48, num_pdfs=64)
        wav = os.path.join(data_dir, "en-us-hello.wav")
        float_hyp = decode_wav_file(Recognizer(conf), wav)

        with open(conf, "a", encoding="utf-8") as fd:
            fd.write("quantized = true\n")
        rec_q = Recognizer(conf)
        assert rec_q.am.quantized
        # Guard-mode calibration on the OTHER wav: en-us-hello then runs
        # against ranges calibrated elsewhere, exercising the fallback.
        import jax.numpy as jnp
        cal = read_16k_pcm(os.path.join(data_dir, "en-us-cat.wav"))
        feats = np.asarray(fbank_from_wave(jnp.asarray(cal),
                                           num_frames(cal.shape[0])))
        rec_q.am.calibrate(rec_q.am.pad_context(feats), guard=True)
        quant_hyp = decode_wav_file(rec_q, wav)
        assert quant_hyp == float_hyp
