"""chip_smoke.py's phases at toy size on the CPU, and its device contract.

The script runs the whole path at full width on the card; here the same
phase functions run on a small trie, so a broken phase shows up before a
chip run.  The script itself must refuse to run without a GPU.
"""

import importlib.util
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


def _load():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod  # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


cs = _load()

TOY = cs.Sizes(num_words=150, trie_kwargs=(("num_phones", 30),
                                           ("bigram_states", 40),
                                           ("variants", 2)),
               hidden=32, tdnn_layers=2, batch=2, seconds=1.0, beam_size=64,
               expand_size=1024, eps_expand_size=256, lm_expand_size=0,
               chunk_frames=20, cli_batch=2, wav_seconds=1.0, oracle_utts=1,
               max_wer=0.5, four_gpu_batch=8, four_gpu_seconds=0.5)


@pytest.fixture(scope="module")
def dep():
    return cs.build_deployment(TOY, seed=0)


@pytest.fixture(scope="module")
def logp_am(dep):
    logp, _ = cs.phase_am(dep)
    return logp


@pytest.fixture(scope="module")
def offline(dep, logp_am, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("smoke"))
    confs = cs.write_models(TOY, 0, tmp)
    scp, entries = cs.write_wavs(tmp, TOY.cli_batch, TOY.wav_seconds, 0)
    transcripts, rec, lp = cs.phase_offline(dep, TOY, logp_am, confs, scp)
    return transcripts, rec, lp, entries, confs


class TestPhasesAtToySize:
    def test_frontend(self):
        cs.phase_frontend()

    def test_deployment_shapes(self, dep):
        assert dep.planted.shape[0] == TOY.batch
        assert dep.wave.shape == (TOY.batch, int(TOY.seconds * 16000))
        assert dep.planted.shape[2] == dep.am.num_pdfs
        assert dep.cfg_lm.lm_expand_size == TOY.lm_expand_size

    def test_am(self, dep, logp_am):
        from catears_tpu.frontend.fbank import num_frames

        t = num_frames(dep.wave.shape[1])
        assert logp_am.shape == (TOY.batch, t, dep.am.num_pdfs)
        assert np.isfinite(np.asarray(logp_am)).all()

    def test_offline(self, offline):
        transcripts, rec, lp, entries, _ = offline
        assert sorted(transcripts) == [name for name, _ in entries]
        assert rec.delta_lm is None
        assert lp.shape[0] == TOY.batch

    def test_model_confs(self, offline):
        conf_off, conf_on = offline[4]
        text_on = open(conf_on, encoding="utf-8").read()
        text_off = open(conf_off, encoding="utf-8").read()
        assert "large_lm" in text_on and "lm_expand_size" in text_on
        assert "large_lm" not in text_off
        assert f"beam_size = {TOY.beam_size}" in text_off

    def test_streaming(self, offline):
        transcripts, rec, _, entries, _ = offline
        cs.phase_streaming(rec, entries, transcripts)

    def test_memory(self, dep):
        cs.phase_memory(dep, TOY)

    def test_four_devices(self, dep):
        """The 4-GPU phase on 4 of the 8 virtual CPU devices."""
        cs.phase_four_gpus(dep, TOY, seed=0)

    def test_float64_reference_matches_device_forward(self, dep):
        import jax.numpy as jnp

        from catears_tpu.am.nnet import nnet_forward

        x = np.random.RandomState(0).randn(30, 40).astype(np.float32)
        x = dep.am.pad_context(x)
        ref = cs.nnet_forward_f64(dep.am.nnet_def, dep.am.params, x)
        got = np.asarray(nnet_forward(dep.am.nnet_def, dep.am.params,
                                      jnp.asarray(x)))
        np.testing.assert_allclose(got, ref, atol=1e-4)

    def test_gemm_kind(self):
        assert cs._gemm_kind('custom_call_target="__cublas$gemm"') == \
            "__cublas$gemm"
        assert cs._gemm_kind("fusion kind=kLoop") == ""


class TestDeviceContract:
    def test_device_phase_raises_without_gpu(self):
        with pytest.raises(RuntimeError, match="no GPU"):
            cs.phase_device()

    @pytest.mark.parametrize("argv", [[], ["--four-gpus"]])
    def test_script_fails_without_gpu(self, argv):
        proc = subprocess.run([sys.executable, SCRIPT] + argv, cwd=ROOT,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
        assert "no GPU" in proc.stderr

    def test_script_alone_fails(self, tmp_path):
        shutil.copy(SCRIPT, tmp_path)
        proc = subprocess.run([sys.executable, "chip_smoke.py"],
                              cwd=tmp_path, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
