#!/usr/bin/env python
"""On-card smoke test: the whole ASR path at full width on one GPU.

Run from the repository root:

    python chip_smoke.py              # one GPU: phases (a)-(f) below
    python chip_smoke.py --four-gpus  # four GPUs: sharded vs unsharded only

One process opens the card(s) once.  Phases, in order; any failure ends
the run with a non-zero exit code and no result line:

  a. device     JAX's first device is a GPU; prints its kind, the device
                count, the JAX version, the compile-cache directory and the
                card's nvidia-smi name and power limit.
  b. frontend   fbank vs the Kaldi dump (1e-4); online CMVN, host and device,
                vs the Kaldi CMVN dump (1e-3, as tests/test_frontend.py).
  c. am         TDNN forward vs a float64 numpy forward of the same weights;
                each int8 GEMM shape vs float (1% of range on random
                operands, reference test/gemm_test.cc:120) and the int8 AM
                vs the float AM (5% of range); the
                s8 matmul vs exact integers, and the library GEMM it lowers
                to.
  d. offline    the CLI's --batch path in process (LM-off and LM-on);
                BatchDecoder on the planted batch (WER); device transcripts
                vs OracleDecoder on the same device log-probs; the one-hot
                acoustic lookup vs a plain gather (bit-exact).
  e. streaming  the fused single-stream session and a 4-stream batch
                session transcribe exactly like the offline decode (the
                CLI's transcripts, and BatchDecoder's final_fallback words
                and path cost).
  f. memory     peak bytes in use and the compiled offline step's memory
                analysis.

Model ("trie" deployment of bench.py), generated from --seed, nothing
downloaded: a 50k-word prefix-trie HCLG (617,940 states, 1,466,600 arcs
after prepare_decode_graph, 3,600 pdfs), a TDNN AM of hidden size 1024 and
5 layers with random weights, the delta-LM G' of make_big_lm (100,003
states), beam 2048 / expand 32768 / eps 1024, LM walk cap 384.

The last line of stdout is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import sys
import tempfile
import time
import wave as wavmod
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA_DIR = os.path.join(ROOT, "tests", "data")


@dataclass(frozen=True)
class Sizes:
    """Every size the phases use; FULL is the deployment, tests use toys."""

    num_words: int = 50_000
    trie_kwargs: Tuple[Tuple[str, int], ...] = ()
    hidden: int = 1024
    tdnn_layers: int = 5
    batch: int = 16  # planted offline batch
    seconds: float = 10.0
    beam_size: int = 2048
    expand_size: int = 32768
    eps_expand_size: int = 1024
    lm_expand_size: int = 384
    chunk_frames: int = 50
    cli_batch: int = 4  # CLI --batch=N, WAVs per model, streams
    wav_seconds: float = 3.0
    oracle_utts: int = 2
    max_wer: float = 0.03  # round 5: 0.024 LM-off, 0.027 LM-on, same seed
    four_gpu_batch: int = 16
    four_gpu_seconds: float = 4.0


FULL = Sizes()
# Stated tolerances (reasons in PERF.md):
AM_F64_ATOL = 1e-3  # f32 AM log-likelihood vs float64 numpy
QUANT_REL = 0.01  # int8 vs float GEMM, max error / output range
QUANT_STACK_REL = 0.05  # int8 vs float AM (5 layers), error / range
LOGP_SHARD_ATOL = 1e-3  # sharded vs unsharded AM log-likelihood
COST_ATOL = 1e-3  # sharded vs unsharded beam costs
STREAM_COST_ATOL = 1e-3  # streaming vs offline best-path cost


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def timed(label: str):
    t0 = time.perf_counter()
    yield
    log(f"# smoke timing: {label} {time.perf_counter() - t0:.1f} s wall")


# -- (a) device ---------------------------------------------------------------

def phase_device(count: int = 1):
    """Check the GPU(s) and print what the run is on; returns the device."""
    import jax

    from catears_tpu.utils.device import (
        enable_compile_cache,
        gpu_name_and_power_limit,
        require_gpu,
    )

    cache = enable_compile_cache()
    dev = require_gpu()
    n = len(jax.devices())
    if n < count:
        raise RuntimeError(f"need {count} GPUs, JAX sees {n}")
    log(f"device_kind={dev.device_kind} device_count={n} "
        f"jax={jax.__version__} compile_cache={cache}")
    log(f"nvidia-smi: {gpu_name_and_power_limit()}")
    return dev


# -- (b) frontend -------------------------------------------------------------

def _golden(name: str) -> np.ndarray:
    return np.loadtxt(os.path.join(DATA_DIR, name)).reshape(-1, 40)


def phase_frontend() -> None:
    import jax.numpy as jnp

    from catears_tpu.frontend.cmvn import CMVN_WINDOW, OnlineCMVN
    from catears_tpu.frontend.fbank import Fbank
    from catears_tpu.io.binfmt import read_vec0_file
    from catears_tpu.io.wav import read_16k_pcm
    from catears_tpu.runtime.streaming import _device_cmvn_chunk

    wave = read_16k_pcm(os.path.join(DATA_DIR, "en-us-hello.wav"))
    feats = Fbank().compute(wave)
    gold = _golden("fbankmat_en-us-hello.wav.txt")
    err = float(np.abs(feats - gold).max())
    log(f"fbank vs Kaldi: max abs err {err:.3g} (limit 1e-4)")
    assert feats.shape == gold.shape and err < 1e-4, err

    stats = read_vec0_file(os.path.join(DATA_DIR, "cmvn_stats.bin"))
    gold = _golden("fbankcmvnmat_en-us-hello.wav.txt")
    host = OnlineCMVN(stats).apply(feats)
    dev, _, _ = _device_cmvn_chunk(
        jnp.asarray(stats[:40], jnp.float32), jnp.float32(stats[40]),
        jnp.zeros((CMVN_WINDOW, 40), jnp.float32), jnp.int32(0),
        jnp.asarray(feats))
    for name, got in (("host", host), ("device", np.asarray(dev))):
        err = float(np.abs(got - gold).max())
        log(f"cmvn ({name}) vs Kaldi: max abs err {err:.3g} (limit 1e-3)")
        assert got.shape == gold.shape and err < 1e-3, (name, err)


# -- shared deployment --------------------------------------------------------

@dataclass
class Deployment:
    am: object  # AcousticModel, float weights
    fst: object  # prepared (eps-free) FlatFst
    tid2pdf: np.ndarray
    dfst: object
    delta_lm: object
    cfg: object  # BeamConfig, LM off
    cfg_lm: object  # BeamConfig, LM on
    planted: np.ndarray  # [B, T, P]
    true_words: List[List[int]]
    wave: np.ndarray  # [B, S] float32


def build_deployment(sizes: Sizes, seed: int) -> Deployment:
    """The trie deployment, drawn in bench.build_bench_setup's order."""
    from catears_tpu.am.model import AcousticModel
    from catears_tpu.am.nnet import build_nnet
    from catears_tpu.decode.beam import BeamConfig
    from catears_tpu.frontend.fbank import num_frames
    from catears_tpu.graph.device import DeviceFst
    from catears_tpu.graph.transform import prepare_decode_graph
    from catears_tpu.tools.biggraph import (
        make_big_lm,
        make_trie_graph,
        plant_logp,
    )
    from catears_tpu.tools.toy import make_toy_nnet

    rng = np.random.RandomState(seed)
    tg = make_trie_graph(rng, num_words=sizes.num_words,
                         **dict(sizes.trie_kwargs))
    samples = int(sizes.seconds * 16000)
    planted, true_words = plant_logp(rng, tg, sizes.batch,
                                     num_frames(samples))
    nnet = make_toy_nnet(rng, hidden=sizes.hidden, num_pdfs=tg.num_pdfs,
                         num_tdnn_layers=sizes.tdnn_layers)
    wave = (rng.randn(sizes.batch, samples) * 1000).astype(np.float32)
    nnet_def, params = build_nnet(nnet)
    prior = np.full(tg.num_pdfs, 1.0 / tg.num_pdfs, np.float32)
    am = AcousticModel(nnet_def, params, np.log(prior), tg.tid2pdf,
                       nnet.left_context, nnet.right_context,
                       chunk_size=50, num_pdfs=tg.num_pdfs)
    fst, olab2, mode = prepare_decode_graph(tg.fst)
    assert mode == "eps_free", mode
    log(f"trie HCLG: {fst.num_states} states, {fst.num_arcs} arcs, "
        f"{tg.num_pdfs} pdfs")
    dfst = DeviceFst.build(fst, tg.tid2pdf, group=2, csr_group=16,
                           eps_depth_cap=1, olabel2=olab2)
    big = make_big_lm(np.random.RandomState(seed), num_words=sizes.num_words)
    log(f"delta-LM G': {big.num_states} states, {big.num_arcs} arcs")
    cfg = BeamConfig(beam_size=sizes.beam_size,
                     expand_size=sizes.expand_size,
                     eps_expand_size=sizes.eps_expand_size,
                     max_eps_iters=3, beam=16.0)
    cfg_lm = dataclasses.replace(cfg, lm_expand_size=sizes.lm_expand_size)
    return Deployment(am, fst, tg.tid2pdf, dfst, big.delta_lm(), cfg,
                      cfg_lm, planted, true_words, wave)


# -- (c) acoustic model -------------------------------------------------------

def nnet_forward_f64(nnet_def, params, x: np.ndarray) -> np.ndarray:
    """Plain float64 numpy forward of the layer stack (the reference)."""
    x = np.asarray(x, np.float64)
    for layer, p in zip(nnet_def, params):
        kind = layer[0]
        p = {k: np.asarray(v, np.float64) for k, v in p.items()}
        if kind == "linear":
            x = x @ p["w"] + p["b"]
        elif kind == "relu":
            x = np.maximum(x, 0.0)
        elif kind == "batchnorm":
            x = x * p["scale"] + p["offset"]
        elif kind == "splice":
            t = x.shape[0]
            idx = np.clip(np.arange(t)[:, None] + np.asarray(layer[1]),
                          0, t - 1)
            x = x[idx].reshape(t, -1)
        elif kind == "narrow":
            left, right = layer[1], layer[2]
            if x.shape[0] > left + right:
                x = x[left:x.shape[0] - right]
        elif kind == "normalize":
            x = x * np.sqrt(x.shape[-1] / np.sum(x * x, -1, keepdims=True))
        elif kind in ("softmax", "logsoftmax"):
            z = x - x.max(-1, keepdims=True)
            z = z - np.log(np.exp(z).sum(-1, keepdims=True))
            x = np.exp(z) if kind == "softmax" else z
        else:
            raise ValueError(kind)
    return x


def _range_error(ref: np.ndarray, got: np.ndarray) -> float:
    return float(np.abs(ref - got).max() / max(ref.max() - ref.min(), 1e-9))


def _gemm_kind(hlo: str) -> str:
    """Which library GEMM an optimized HLO module calls, or ''."""
    for tag in ("__cublas$lt$matmul", "__cublas$gemm", "triton_gemm",
                "__triton"):
        if tag in hlo:
            return tag
    return ""


def phase_am(dep: Deployment):
    """Returns (device log-likelihoods [B, T, P] of dep.wave, the library
    GEMM the s8 matmul lowers to or '')."""
    import jax
    import jax.numpy as jnp

    from catears_tpu.am.model import AcousticModel
    from catears_tpu.am.nnet import nnet_forward
    from catears_tpu.am.quant import matmul_s8, qmatmul, quantize
    from catears_tpu.frontend.fbank import fbank_from_wave, num_frames
    from catears_tpu.runtime.batch import batched_logp

    am = dep.am
    t = num_frames(dep.wave.shape[1])
    logp, _ = batched_logp(am, list(dep.wave))
    logp.block_until_ready()
    assert logp.shape == (dep.wave.shape[0], t, am.num_pdfs), logp.shape
    feats = jax.jit(jax.vmap(lambda w: fbank_from_wave(w, t)))(dep.wave)
    padded = np.stack([am.pad_context(f) for f in np.asarray(feats)])

    got = np.asarray(logp)
    ref = np.stack([nnet_forward_f64(am.nnet_def, am.params, x)
                    - np.asarray(am.log_prior, np.float64) for x in padded])
    err = float(np.abs(got - ref).max())
    log(f"AM f32 (HIGHEST) vs float64: max abs err {err:.3g} "
        f"(limit {AM_F64_ATOL})")
    assert np.isfinite(got).all() and err < AM_F64_ATOL, err

    # int8.  The reference's criterion (test/gemm_test.cc:120) is for one
    # GEMM of random normal operands: held at every linear's real shape.
    # On the real activations the per-GEMM errors are printed, and the
    # whole int8 AM, whose GEMM errors add over its layers, is held to 5%.
    qmm = jax.jit(lambda x, w: qmatmul(quantize(x), quantize(w)))
    rng = np.random.RandomState(3)
    for i, (layer, p) in enumerate(zip(am.nnet_def, am.params)):
        if layer[0] != "linear":
            continue
        act = jax.jit(jax.vmap(lambda x, i=i: nnet_forward(
            am.nnet_def[:i], am.params[:i], x)))(padded)
        act = np.asarray(act.reshape(-1, act.shape[-1]), np.float64)
        w = np.asarray(p["w"], np.float64)
        real = _range_error(act @ w, np.asarray(qmm(act.astype(np.float32),
                                                    p["w"])))
        a = rng.randn(*act.shape)
        b = rng.randn(*w.shape) * 2 + 0.5
        rel = _range_error(a @ b, np.asarray(qmm(a.astype(np.float32),
                                                 b.astype(np.float32))))
        log(f"int8 GEMM layer {i} [{act.shape[0]},{act.shape[1]}]x"
            f"{w.shape}: max err / range {rel:.4f} on random operands "
            f"(limit {QUANT_REL}), {real:.4f} on the AM's activations")
        assert rel < QUANT_REL, (i, rel)
    am_q = AcousticModel(am.nnet_def, am.params, np.asarray(am.log_prior),
                         am.tid2pdf, am.left_context, am.right_context,
                         am.chunk_size, am.num_pdfs, quantized=True)
    got_q = np.asarray(batched_logp(am_q, list(dep.wave))[0])
    rel = _range_error(got, got_q)
    prior = np.asarray(am.log_prior)
    dprob = float(np.abs(np.exp(got_q + prior) - np.exp(got + prior)).max())
    log(f"AM int8 vs float: max err / range {rel:.4f} (limit "
        f"{QUANT_STACK_REL}), max probability diff {dprob:.4f}")
    assert rel < QUANT_STACK_REL, rel

    # The largest GEMM of the stack, at the batch's real row count.
    rng = np.random.RandomState(1)
    k, n = max((p["w"].shape for layer, p in zip(am.nnet_def, am.params)
                if layer[0] == "linear"), key=lambda kn: kn[0] * kn[1])
    m = padded.shape[0] * padded.shape[1]
    a = rng.randint(-128, 128, size=(m, k)).astype(np.int8)
    b = rng.randint(-128, 128, size=(k, n)).astype(np.int8)
    mm = jax.jit(matmul_s8)
    out = np.asarray(mm(a, b))
    # |sum| <= k * 2^14 < 2^53: the float64 product is exact.
    exact = (a.astype(np.float64) @ b.astype(np.float64)).astype(np.int64)
    assert out.dtype == np.int32 and np.array_equal(out, exact), \
        "s8 matmul differs from the exact integer product"
    gemm = _gemm_kind(mm.lower(jnp.asarray(a), jnp.asarray(b))
                      .compile().as_text())
    log(f"s8 matmul [{m},{k}]x[{k},{n}] exact; lowers to "
        f"{gemm or 'no library GEMM'}")
    return logp, gemm


# -- (d) offline decode -------------------------------------------------------

def write_wavs(out_dir: str, n: int, seconds: float, seed: int):
    """n seeded noise WAVs (16 kHz, 16 bit) and their .scp; returns
    (scp path, [(name, path)])."""
    rng = np.random.RandomState(seed + 1)
    entries = []
    for i in range(n):
        # Lengths differ so the batch is ragged.
        samples = int(seconds * 16000 * (1.0 - 0.1 * i / max(n, 1)))
        pcm = np.clip(rng.randn(samples) * 1000, -32768, 32767)
        path = os.path.join(out_dir, f"utt{i}.wav")
        with wavmod.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(pcm.astype("<i2").tobytes())
        entries.append((f"utt{i}", path))
    scp = os.path.join(out_dir, "wavs.scp")
    with open(scp, "w", encoding="utf-8") as fd:
        fd.writelines(f"{name} {path}\n" for name, path in entries)
    return scp, entries


def write_models(sizes: Sizes, seed: int, out_dir: str) -> Tuple[str, str]:
    """(LM-off conf, LM-on conf) over one trie model directory.

    The graph is the first draw of RandomState(seed), as in
    build_deployment, so planted log-probs walk its paths too.
    """
    from catears_tpu.tools.biggraph import write_trie_model

    conf_on = write_trie_model(
        out_dir, np.random.RandomState(seed), num_words=sizes.num_words,
        hidden=sizes.hidden, with_lm=True, num_tdnn_layers=sizes.tdnn_layers,
        **dict(sizes.trie_kwargs))
    geometry = (f"beam_size = {sizes.beam_size}\n"
                f"expand_size = {sizes.expand_size}\n"
                f"eps_expand_size = {sizes.eps_expand_size}\n"
                "max_eps_iters = 3\nbeam = 16\n")
    with open(conf_on, encoding="utf-8") as fd:
        base = fd.read()
    conf_off = os.path.join(out_dir, "trie_lm_off.conf")
    with open(conf_off, "w", encoding="utf-8") as fd:
        fd.write("".join(line for line in base.splitlines(True)
                         if not line.startswith(("large_lm", "original_lm")))
                 + geometry)
    with open(conf_on, "a", encoding="utf-8") as fd:
        fd.write(geometry + f"lm_expand_size = {sizes.lm_expand_size}\n")
    return conf_off, conf_on


def run_cli(args: List[str]) -> dict:
    """catears_tpu.cli.main in this process; returns {name: transcript}."""
    from catears_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    assert rc == 0, rc
    out = {}
    for line in buf.getvalue().splitlines():
        name, _, hyp = line.partition(" ")
        out[name] = hyp
    return out


def word_error_rate(true_words, hyps) -> float:
    from catears_tpu.tools.score import edit_distance

    errs = sum(edit_distance(t, h.words)[0] for t, h in zip(true_words, hyps))
    return errs / max(1, sum(len(t) for t in true_words))


def oracle_words(rec, logp: np.ndarray) -> List[int]:
    """OracleDecoder on one utterance's [T, P] log-probs, choosing the
    final hypothesis like BatchDecoder.decode(final_fallback=True)."""
    import math

    from catears_tpu.decode.oracle import OracleDecoder

    cfg = rec.beam_config
    o = OracleDecoder(rec.fst, rec.am.tid2pdf, am_scale=cfg.am_scale,
                      beam=cfg.beam, beam_size=cfg.beam_size,
                      max_eps_iters=cfg.max_eps_iters,
                      delta_lm=rec.delta_lm, one_pass_eps=True)
    for row in logp:
        o.process(row)
    lm = rec.delta_lm
    has_final = any(
        math.isfinite(c + rec.fst.final_weight(s)
                      + (lm.final(m) if lm is not None else 0.0))
        for (s, m), (c, _) in o.tokens.items())
    return o.best_path(end_of_stream=has_final).words


def acoustic_lookup_exact(cfg, rows) -> None:
    """The decoder's one-hot acoustic lookup vs a plain gather, at the
    decoder's real candidate width; must agree bit for bit."""
    import jax
    import jax.numpy as jnp

    from catears_tpu.decode.beam import _acoustic_lookup

    b, p = rows.shape
    e = cfg.beam_size * 3 + cfg.expand_size  # self-loop + G=2 block + CSR
    pdf = jnp.asarray(np.random.RandomState(2).randint(0, p, size=(b, e)),
                      jnp.int32)
    got = jax.jit(jax.vmap(_acoustic_lookup))(rows, pdf)
    want = jax.vmap(lambda r, i: r[i])(rows, pdf)
    assert np.array_equal(np.asarray(got), np.asarray(want)), \
        "acoustic lookup is not bit-exact"
    log(f"acoustic lookup [{b} x {e} candidates, {p} pdfs] bit-exact")


def phase_offline(dep: Deployment, sizes: Sizes, logp_am, confs, scp: str):
    """Returns ({name: transcript} of the LM-off CLI run, the LM-off
    Recognizer, the offline step's planted device log-probs)."""
    import jax.numpy as jnp

    from catears_tpu.decode.decoder import BatchDecoder
    from catears_tpu.runtime.batch import get_batch_decoder
    from catears_tpu.runtime.recognizer import Recognizer

    # Planted paths dominate; the 1e-3 AM term keeps the AM's output in
    # the decoded log-probs without disturbing them (as bench.py).
    lp = jnp.asarray(dep.planted) + 1e-3 * logp_am
    acoustic_lookup_exact(dep.cfg, lp[:, 0])

    offline, recs = {}, {}
    for tag, conf in zip(("lm-off", "lm-on"), confs):
        with timed(f"cli --batch={sizes.cli_batch} {tag}"):
            got = run_cli([f"--batch={sizes.cli_batch}", conf, scp])
        log(f"[{tag}] cli: {got}")
        assert len(got) == sizes.cli_batch, got
        offline[tag] = got

        cfg = dep.cfg_lm if tag == "lm-on" else dep.cfg
        dec = BatchDecoder(dep.fst, dep.tid2pdf, config=cfg,
                           chunk_frames=sizes.chunk_frames, dfst=dep.dfst,
                           delta_lm=dep.delta_lm if tag == "lm-on" else None)
        with timed(f"planted BatchDecoder {tag}"):
            hyps = dec.decode(lp, final_fallback=True,
                              retry_on_overflow=False)
        wer = word_error_rate(dep.true_words, hyps)
        log(f"[{tag}] planted {lp.shape[0]} x {sizes.seconds} s: WER "
            f"{wer:.4f} (limit {sizes.max_wer}), capacity_hiwater "
            f"{dec.capacity_high_water}, no overflow")
        assert wer <= sizes.max_wer, wer

        rec = recs[tag] = Recognizer(conf)
        n, frames = sizes.cli_batch, int(sizes.wav_seconds * 100)
        sub = lp[:n, :frames]
        with timed(f"oracle {tag}"):
            dev_hyps = get_batch_decoder(rec).decode(
                sub, final_fallback=True, retry_on_overflow=False)
            sub_np = np.asarray(sub)
            for u in range(sizes.oracle_utts):
                want = oracle_words(rec, sub_np[u])
                log(f"[{tag}] utt {u}: device {dev_hyps[u].words} oracle "
                    f"{want}")
                assert dev_hyps[u].words == want, (tag, u)
    return offline["lm-off"], recs["lm-off"], lp


# -- (e) streaming ------------------------------------------------------------

def fallback_hyp(best_path):
    """BatchDecoder's final_fallback over a session's best_path: the
    end-of-stream hypothesis, or, when no final state is reachable (the
    reference's empty answer, Hypothesis([], 0.0)), the cheapest token's."""
    hyp = best_path(True)
    if hyp.words or hyp.weight != 0.0:
        return hyp
    return best_path(False)


def _same_hyp(got, want) -> bool:
    return (got.words == want.words
            and abs(got.weight - want.weight) <= STREAM_COST_ATOL)


def phase_streaming(rec, entries, offline: dict) -> None:
    """Both sessions vs the offline decode of the same WAVs: the CLI's
    transcripts, and the batch decoder's final_fallback hypotheses, words
    and path cost.  Noise audio through a random AM rarely completes a
    word, so the cost is what shows that the beams followed one path."""
    from catears_tpu.io.wav import read_pcm_header
    from catears_tpu.runtime.batch import (
        batched_logp,
        get_batch_decoder,
        load_waves,
    )

    waves = load_waves([p for _, p in entries])
    logp, lengths = batched_logp(rec.am, waves)
    want = get_batch_decoder(rec).decode(
        logp, lengths, final_fallback=True, retry_on_overflow=False)

    name, path = entries[0]
    with timed("fused session, 1 stream"):
        with open(path, "rb") as fd:
            utt = rec.create_utterance(read_pcm_header(fd))
            while chunk := fd.read(1024):
                utt.process(chunk)
        utt.end_of_stream()
    got = fallback_hyp(utt.session.best_path)
    log(f"fused session {name}: {utt.hyp!r} (offline {offline[name]!r}), "
        f"fallback {got} (offline {want[0]})")
    assert utt.hyp == offline[name] and _same_hyp(got, want[0])

    table = rec.symbol_table
    sess = rec.create_stream_batch(len(entries))
    feed = 3200  # 200 ms per stream per tick
    with timed(f"batch session, {len(entries)} streams"):
        for off in range(0, max(w.size for w in waves), feed):
            sess.process_batch([w[off:off + feed] for w in waves])
            sess.partials()
        for u in range(len(entries)):
            sess.end_of_stream(u)
    for u, (name, _) in enumerate(entries):
        hyp = " ".join(table.get(w) for w in
                       sess.best_path(u, end_of_stream=True).words)
        got = fallback_hyp(lambda eos: sess.best_path(u, eos))
        log(f"batch session {name}: {hyp!r}, fallback {got} (offline "
            f"{want[u]})")
        assert hyp == offline[name], (name, hyp, offline[name])
        assert _same_hyp(got, want[u]), (name, got, want[u])


# -- (f) memory ---------------------------------------------------------------

def phase_memory(dep: Deployment, sizes: Sizes) -> None:
    import jax
    import jax.numpy as jnp

    from catears_tpu.decode.beam import decode_chunk, init_beam_batch

    b, p = dep.planted.shape[0], dep.planted.shape[2]
    beam, _ = init_beam_batch(dep.cfg, False, b, dep.dfst, None)
    lp = jnp.zeros((sizes.chunk_frames, b, p), jnp.float32)
    valid = jnp.ones((sizes.chunk_frames, b), bool)
    t0 = time.perf_counter()
    compiled = decode_chunk.lower(dep.cfg, False, dep.dfst, None, beam, lp,
                                  valid).compile()
    log(f"# smoke timing: offline step compile (cache may hit) "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"offline step [{sizes.chunk_frames} frames x {b} utts] "
        f"memory_analysis: {compiled.memory_analysis()}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"peak_bytes_in_use {stats.get('peak_bytes_in_use')}")


# -- four GPUs ----------------------------------------------------------------

def phase_four_gpus(dep: Deployment, sizes: Sizes, seed: int) -> None:
    """ShardedPipeline on 4 devices (dp=4 and dp=2 x tp=2) vs one device."""
    import jax
    import jax.numpy as jnp

    from catears_tpu.decode.beam import decode_chunk, init_beam_batch
    from catears_tpu.frontend.fbank import fbank_from_wave, num_frames
    from catears_tpu.parallel.mesh import ShardedPipeline, make_mesh

    am = dep.am
    b = sizes.four_gpu_batch
    samples = int(sizes.four_gpu_seconds * 16000)
    t = num_frames(samples)
    rng = np.random.RandomState(seed + 2)
    wave = (rng.randn(b, samples) * 1000).astype(np.float32)
    lengths = rng.randint(t // 2, t + 1, size=b).astype(np.int32)
    devices = jax.devices()[:4]
    results = {}
    for mp in (1, 2):
        mesh = make_mesh(4, model_parallel=mp)
        pipe = ShardedPipeline(am, dep.dfst, None, dep.cfg, mesh)
        w = jax.device_put(wave, pipe.data_sharding)
        lens = jax.device_put(lengths, pipe.data_sharding)
        with mesh, timed(f"sharded step dp={4 // mp} tp={mp}"):
            step = pipe.jit_full_step(t)
            logp, beam, _ = step(w, pipe.make_beam(b), lens)
            logp.block_until_ready()
        for name, arr in (("logp", logp), ("beam.costs", beam.costs),
                          ("first linear w", pipe.params[2]["w"])):
            held = {s.device for s in arr.addressable_shards}
            shapes = sorted({s.data.shape for s in arr.addressable_shards})
            log(f"dp={4 // mp} tp={mp} {name}: {len(held)} cards hold "
                f"shards of shape {shapes} (global {arr.shape})")
            assert held == set(devices), (name, held)
        results[mp] = (np.asarray(logp), np.asarray(beam.states),
                       np.asarray(beam.costs))
    # An SPMD program holds about the same on every card; code that put
    # everything on the first card would show here.  (The CPU backend keeps
    # no memory stats.)
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in devices]
    log(f"per-card peak_bytes_in_use after the sharded steps: {peaks}")
    if None not in peaks:
        assert min(peaks) >= 0.5 * max(peaks), peaks

    def one(w):
        feats = fbank_from_wave(w, t)
        idx = jnp.clip(jnp.arange(t + am.left_context + am.right_context)
                       - am.left_context, 0, t - 1)
        return am.forward_padded(feats[idx])

    with timed("unsharded reference on one card"):
        ref_logp = np.asarray(jax.jit(jax.vmap(one))(jnp.asarray(wave)))
        valid = jnp.asarray(np.arange(t)[:, None] < lengths[None, :])
        for mp, (logp, states, costs) in results.items():
            err = float(np.abs(logp - ref_logp).max())
            log(f"dp={4 // mp} tp={mp}: logp vs one card max abs err "
                f"{err:.3g} (limit {LOGP_SHARD_ATOL})")
            assert err < LOGP_SHARD_ATOL, err
            # The one-card decode of the same log-probs: decoding is exact
            # given its input, so states must match slot for slot.
            beam0, _ = init_beam_batch(dep.cfg, False, b, dep.dfst, None)
            beam_ref, _ = decode_chunk(
                dep.cfg, False, dep.dfst, None, beam0,
                jnp.asarray(np.transpose(logp, (1, 0, 2))), valid)
            assert np.array_equal(states, np.asarray(beam_ref.states)), mp
            ref_costs = np.asarray(beam_ref.costs)
            fin = np.isfinite(costs)
            assert np.array_equal(fin, np.isfinite(ref_costs)), mp
            cerr = float(np.abs(costs[fin] - ref_costs[fin]).max())
            log(f"dp={4 // mp} tp={mp}: beam states equal, costs max abs "
                f"diff {cerr:.3g} (limit {COST_ATOL})")
            assert cerr <= COST_ATOL, cerr


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the 4-GPU sharded path and its "
                         "one-card reference")
    args = ap.parse_args(argv)
    import jax

    t_start = time.perf_counter()
    sizes = FULL
    with timed("device"):
        dev = phase_device(4 if args.four_gpus else 1)
    with timed("build deployment"):
        dep = build_deployment(sizes, args.seed)
    if args.four_gpus:
        phase_four_gpus(dep, sizes, args.seed)
    else:
        with timed("frontend"):
            phase_frontend()
        with timed("am"):
            logp_am, gemm = phase_am(dep)
        with tempfile.TemporaryDirectory() as tmp, timed("offline"):
            confs = write_models(sizes, args.seed, tmp)
            scp, entries = write_wavs(tmp, sizes.cli_batch,
                                      sizes.wav_seconds, args.seed)
            offline, rec, _ = phase_offline(dep, sizes, logp_am, confs, scp)
            with timed("streaming"):
                phase_streaming(rec, entries, offline)
        with timed("memory"):
            phase_memory(dep, sizes)
        assert gemm, "s8 matmul did not lower to a library GEMM"
    log(f"# smoke timing: total {time.perf_counter() - t_start:.1f} s wall")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
