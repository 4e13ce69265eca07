"""Accuracy realism + headline-scale parity vs the reference binary.

Closes the two evidence gaps of the planted-likelihood bench in one
experiment (SURVEY.md §6, /root/reference/doc/debug.md methodology):

  1. TRAINED acoustics: a TDNN is trained (on device, with this
     framework's own fbank front-end) on synthetic formant-like phone
     audio for the 50k-word trie HCLG — so decodes run on genuinely
     confusable posteriors produced by a real wave -> fbank -> AM path,
     not on planted pseudo-likelihoods.
  2. SIDE-BY-SIDE decode: the SAME model artifacts and the SAME wav
     files go through this framework (beam-2048 production geometry) and
     through the compiled reference binary (30k-token budget,
     /root/reference/src/decoder.h:54).  Reported: WER of each engine
     against the true word sequences, transcript agreement between
     engines, a WER-vs-beam curve under trained acoustics, and
     transcript parity on the two real test WAVs at full 618k-state
     scale.

Round-5 additions:
  3. DELTA-LM accuracy: training word sequences (now drawn from a hidden
     Markov word chain, so bigrams are learnable) fit a backoff bigram
     ARPA (tools.lm.fit_bigram_arpa); G' is built by tools.arpa (the
     pure-Python arpa2fst) and exported with the unigram subtraction
     vector in BOTH engines' formats (`large_lm`/`original_lm`,
     reference src/ce_stt.cc:82-110).  The 20 test utterances decode
     LM-on in both engines: WER ours-LM-on vs ours-LM-off vs
     reference-LM-on, measured — not implied.
  4. DEEP PARITY: any utterance whose transcript differs from the
     reference at comparable budgets is re-decoded by BOTH engines at
     effectively UNPRUNED budgets (ours: beam 32768; reference: a
     kBeamSize=3M build where only the width-16 beam prunes,
     scripts/build_reference_unpruned.sh) to show the residual
     mismatches are pruning-order effects, not search semantics.

Run (defaults = headline scale, ~40 min incl. reference decodes):
  python scripts/realism.py
Env: WORDS (50000), UTTS_TRAIN (240), UTTS_TEST (20), SECONDS (8),
     STEPS (3000), BEAMS (1024,2048,4096), SKIP_REF=1 to skip the
     reference side, SKIP_LM=1 / SKIP_DEEP=1 to skip the round-5
     sections.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import jax

from catears_tpu.utils.device import enable_compile_cache  # noqa: E402

enable_compile_cache()

from catears_tpu.decode.beam import BeamConfig  # noqa: E402
from catears_tpu.frontend.fbank import num_frames  # noqa: E402
from catears_tpu.tools.biggraph import make_trie_graph  # noqa: E402
from catears_tpu.tools.score import edit_distance  # noqa: E402
from catears_tpu.tools.synth import (  # noqa: E402
    Synthesizer,
    empirical_prior,
    fbank_labels,
    train_am,
    write_trained_model,
    write_wav,
)
from catears_tpu.tools.toy import make_toy_nnet  # noqa: E402

WORDS = int(os.environ.get("WORDS", 50000))
NUM_PHONES = int(os.environ.get("NUM_PHONES", 200))
VARIANTS = int(os.environ.get("VARIANTS", 6))
UTTS_TRAIN = int(os.environ.get("UTTS_TRAIN", 240))
UTTS_TEST = int(os.environ.get("UTTS_TEST", 20))
SECONDS = float(os.environ.get("SECONDS", 8.0))
SNR_NOISE = float(os.environ.get("SNR", 0.12))
LM_INTERP = float(os.environ.get("LM_INTERP", 0.0))
MARKOV_P = float(os.environ.get("MARKOV_P", 0.75))
STEPS = int(os.environ.get("STEPS", 3000))
HIDDEN = int(os.environ.get("HIDDEN", 1024))
BEAMS = [int(b) for b in os.environ.get("BEAMS", "1024,2048,4096").split(",")]
OUT = os.environ.get("OUT_DIR", "/tmp/realism")
REFERENCE_BIN = os.environ.get("CATEARS_REFERENCE_BIN",
                               "/tmp/refbuild/pocketkaldi")
DATA_DIR = os.path.join(os.path.dirname(__file__), "..", "tests", "data")


def log(msg):
    print(f"# {msg}", file=sys.stderr, flush=True)


def compute_feats(samples_list):
    """Batched fbank on device at ONE padded shape (utterances are
    ragged — per-utterance shapes would compile 240 separate programs).
    Slicing the first nf frames of the padded result is exact: fbank
    windows are local and zero-padding only affects frames past nf."""
    import jax
    import jax.numpy as jnp

    from catears_tpu.frontend.fbank import fbank_from_wave

    max_len = max(s.shape[0] for s in samples_list)
    nf_max = num_frames(max_len)
    fb = jax.jit(jax.vmap(lambda w: fbank_from_wave(w, nf_max)))
    bsz = 16
    padded = np.zeros((len(samples_list), max_len), np.float32)
    for i, s in enumerate(samples_list):
        padded[i, :s.shape[0]] = s
    out = []
    for off in range(0, len(samples_list), bsz):
        chunk = padded[off:off + bsz]
        n = chunk.shape[0]
        if n < bsz:
            chunk = np.pad(chunk, ((0, bsz - n), (0, 0)))
        res = np.asarray(fb(jnp.asarray(chunk)))
        for j in range(n):
            nf = num_frames(samples_list[off + j].shape[0])
            out.append(res[j, :nf])
    return out


def wer_of(hyps, refs):
    errs = sum(edit_distance(r, h)[0] for h, r in zip(hyps, refs))
    return errs / max(1, sum(len(r) for r in refs))


def parse_scp_stdout(stdout, n_utts):
    """Transcript lines from a reference scp run.

    The reference's PK_WARN macro prints to STDOUT (src/util.h:39-43), so
    warning lines (e.g. DeltaLmFst's '<s>' start note) interleave with
    `name hyp` lines and must be filtered, not parsed as transcripts.
    """
    hyps = [line.split()[1:] for line in stdout.splitlines()
            if line.startswith("utt")]
    assert len(hyps) == n_utts, (len(hyps), stdout[:500])
    return hyps


def main():
    rng = np.random.RandomState(0)
    frames = int(SECONDS * 100)
    log(f"building {WORDS}-word trie...")
    g = make_trie_graph(rng, num_words=WORDS, num_phones=NUM_PHONES,
                        variants=VARIANTS)
    # markov=True: word sequences carry bigram structure a fitted G' can
    # model — the signal the delta-LM experiment rescoring needs.
    synth = Synthesizer(g, NUM_PHONES, VARIANTS, rng, markov=True,
                        snr_noise=SNR_NOISE, markov_p=MARKOV_P)
    spec = make_toy_nnet(rng, hidden=HIDDEN, num_pdfs=g.num_pdfs,
                         num_tdnn_layers=5)
    left, right = spec.left_context, spec.right_context

    log(f"synthesizing {UTTS_TRAIN} training utterances x {SECONDS}s...")
    waves, all_targets, train_words = [], [], []
    for _ in range(UTTS_TRAIN):
        s, t, ws = synth.utterance(rng, frames)
        waves.append(s)
        all_targets.append(t)
        train_words.append(ws)
    feats = compute_feats(waves)
    data, labels_all = [], []
    for f, t in zip(feats, all_targets):
        lab = fbank_labels(t, f.shape[0])
        labels_all.append(lab)
        data.append((f, lab[left:f.shape[0] - right]))

    log(f"training TDNN-{HIDDEN} ({STEPS} steps)...")
    t0 = time.time()
    spec2, acc = train_am(spec, data, steps=STEPS, log_every=STEPS // 5)
    log(f"trained in {time.time() - t0:.0f}s, dev frame accuracy {acc:.3f}")
    prior = empirical_prior(labels_all, g.num_pdfs)
    our_conf, ref_conf = write_trained_model(OUT, g, spec2, prior)

    log(f"synthesizing {UTTS_TEST} test utterances...")
    test_rng = np.random.RandomState(1234)
    scp_lines, truths = [], []
    for i in range(UTTS_TEST):
        s, _, words = synth.utterance(test_rng, frames)
        path = os.path.join(OUT, f"test{i}.wav")
        write_wav(path, s)
        scp_lines.append(f"utt{i} {path}")
        truths.append([f"word{w}" for w in words])
    scp = os.path.join(OUT, "test.scp")
    with open(scp, "w") as fd:
        fd.write("\n".join(scp_lines) + "\n")
    with open(os.path.join(OUT, "truth.txt"), "w") as fd:
        for i, t in enumerate(truths):
            fd.write(f"utt{i} {' '.join(t)}\n")

    results = {"dev_frame_acc": round(acc, 4), "words": WORDS,
               "snr_noise": SNR_NOISE, "lm_interpolate": LM_INTERP,
               "markov_p": MARKOV_P,
               "num_pdfs": g.num_pdfs, "utts": UTTS_TEST,
               "seconds": SECONDS}

    # --- delta-LM artifacts: corpus-fitted bigram G' for BOTH engines ----
    ours_lm_conf = ref_lm_conf = None
    if os.environ.get("SKIP_LM") != "1":
        from catears_tpu.io.binfmt import write_pkfst, write_vec0
        from catears_tpu.tools.arpa import arpa_to_fst
        from catears_tpu.tools.lm import (
            build_cost_vector,
            fit_bigram_arpa,
            read_unigram_costs,
        )

        vocab_list = [f"word{i}" for i in range(1, WORDS + 1)]
        corpus = [[f"word{w}" for w in ws] for ws in train_words]
        with open(os.path.join(OUT, "corpus.txt"), "w") as fd:
            for ws in train_words:
                fd.write(" ".join(str(w) for w in ws) + "\n")
        arpa_path = os.path.join(OUT, "corpus.arpa")
        with open(arpa_path, "w") as fd:
            fd.write("\n".join(fit_bigram_arpa(
                corpus, vocab_list, interpolate=LM_INTERP)) + "\n")
        vocab_map = {w: i for i, w in enumerate(vocab_list, start=1)}
        vocab_map["<s>"] = WORDS + 1
        vocab_map["</s>"] = WORDS + 2
        gfst, _ = arpa_to_fst(arpa_path, vocab=vocab_map)
        log(f"fitted bigram G': {gfst.num_states} states, "
            f"{gfst.num_arcs} arcs")
        with open(os.path.join(OUT, "lm.fst"), "wb") as fd:
            write_pkfst(fd, gfst.to_raw())
        # original_lm MUST be the unigram G embedded in the HCLG (the
        # trie's word-end arcs carry g.unigram_cost), so the delta
        # cleanly substitutes bigram-for-unigram: total becomes
        # acoustics + HMM weights + G' — the reference's mkgraph recipe
        # (tool/mkgraph_hcl.sh:33-56 builds G from the PRUNED version of
        # the same LM and original_lm from that unigram section).  Using
        # any other vector leaves net-negative per-word deltas that turn
        # rescoring into an insertion storm (measured: WER 0.14/0.96 in
        # the first round-5 run with an add-one ARPA unigram here).
        uni_vec = np.zeros(WORDS + 3, np.float32)
        uni_vec[1:WORDS + 1] = g.unigram_cost[1:]
        uni_vec[WORDS + 1] = 0.0  # <s> := 0 (convert_unigram convention)
        eos_costs = read_unigram_costs(arpa_path)
        uni_vec[WORDS + 2] = -eos_costs["</s>"] * np.log(10.0)
        with open(os.path.join(OUT, "lm.uni"), "wb") as fd:
            write_vec0(fd, uni_vec)
        for base, name in ((our_conf, "ours_lm.conf"),
                           (ref_conf, "ref_lm.conf")):
            with open(base) as fd:
                content = fd.read()
            path = os.path.join(OUT, name)
            with open(path, "w") as fd:
                fd.write(content
                         + "large_lm = lm.fst\noriginal_lm = lm.uni\n")
            if name.startswith("ours"):
                ours_lm_conf = path
            else:
                ref_lm_conf = path

    # --- ours: WER vs beam under trained acoustics -----------------------
    from catears_tpu.runtime.batch import decode_scp
    from catears_tpu.runtime.recognizer import Recognizer

    os.environ.setdefault("CATEARS_TIMING", "1")
    our_hyps = {}
    for beam in BEAMS:
        cfg = BeamConfig(beam_size=beam, expand_size=32768,
                         eps_expand_size=8192, max_eps_iters=3)
        rec = Recognizer(our_conf, beam_config=cfg)
        t0 = time.time()
        hyps = decode_scp(rec, scp, batch_size=min(UTTS_TEST, 10))
        dt = time.time() - t0
        hyp_words = [h.split() for _, h in hyps]
        our_hyps[beam] = hyp_words
        w = wer_of(hyp_words, truths)
        log(f"ours beam={beam}: WER {w:.4f} ({dt:.0f}s)")
        results[f"ours_wer_beam{beam}"] = round(w, 4)

    # --- ours: LM-on ------------------------------------------------------
    our_lm_hyps = None
    if ours_lm_conf is not None:
        for beam in (2048, 4096):
            cfg = BeamConfig(beam_size=beam, expand_size=32768,
                             eps_expand_size=8192, max_eps_iters=3)
            rec = Recognizer(ours_lm_conf, beam_config=cfg)
            assert rec.delta_lm is not None
            t0 = time.time()
            hyps = decode_scp(rec, scp, batch_size=min(UTTS_TEST, 10))
            dt = time.time() - t0
            hyp_words = [h.split() for _, h in hyps]
            if beam == 2048:
                our_lm_hyps = hyp_words
            w = wer_of(hyp_words, truths)
            log(f"ours beam={beam} LM-ON: WER {w:.4f} ({dt:.0f}s)")
            results[f"ours_wer_lm_beam{beam}"] = round(w, 4)

    # --- reference binary at its 30k budget ------------------------------
    # Two reference builds: STOCK (as shipped — at this scale it hits a
    # use-after-free in its OLabel GC and aborts on a large fraction of
    # utterances; discovered round 4, scripts/build_reference_fixed.sh),
    # and FIXED (the one-line pool.h loop-bound fix) for the actual WER
    # side-by-side.
    if os.environ.get("SKIP_REF") != "1" and os.path.exists(REFERENCE_BIN):
        fixed_bin = os.environ.get("CATEARS_REFERENCE_FIXED_BIN",
                                   "/tmp/refbuild_fixed/pocketkaldi")
        if not os.path.exists(fixed_bin):
            subprocess.run(["bash", os.path.join(os.path.dirname(__file__),
                                                 "build_reference_fixed.sh")],
                           check=True, capture_output=True, timeout=600)
        stock_crashes = 0
        stock_hyps = {}
        t0 = time.time()
        for i in range(UTTS_TEST):
            wav = os.path.join(OUT, f"test{i}.wav")
            r = subprocess.run([REFERENCE_BIN, ref_conf, wav],
                               capture_output=True, text=True, timeout=3600)
            if r.returncode != 0:
                stock_crashes += 1
            else:
                stock_hyps[i] = r.stdout.split()
        log(f"stock reference: {stock_crashes}/{UTTS_TEST} utterances "
            f"ABORT (OLabel GC use-after-free at 50k-word scale) "
            f"({time.time() - t0:.0f}s)")
        results["ref_stock_crashes"] = f"{stock_crashes}/{UTTS_TEST}"

        t0 = time.time()
        ref_out = subprocess.run([fixed_bin, ref_conf, scp],
                                 capture_output=True, text=True,
                                 timeout=7200)
        dt = time.time() - t0
        assert ref_out.returncode == 0, ref_out.stderr[-2000:]
        ref_hyps = parse_scp_stdout(ref_out.stdout, UTTS_TEST)
        w = wer_of(ref_hyps, truths)
        log(f"reference GC-FIXED (30k budget): WER {w:.4f} ({dt:.0f}s)")
        results["ref_wer_30k"] = round(w, 4)
        results["ref_decode_s"] = round(dt, 1)
        # Where the stock binary survives, it must agree with the fixed
        # one (the fix only prevents freed-node walks).
        stock_agree = sum(1 for i, h in stock_hyps.items()
                          if h == ref_hyps[i])
        results["ref_stock_eq_fixed"] = f"{stock_agree}/{len(stock_hyps)}"
        # engine-vs-engine transcript agreement at the production beam
        prod = our_hyps.get(2048) or our_hyps[max(our_hyps)]
        agree = sum(1 for a, b in zip(prod, ref_hyps) if a == b)
        cross = wer_of(prod, ref_hyps)
        results["transcripts_identical"] = f"{agree}/{UTTS_TEST}"
        results["cross_wer_ours_vs_ref"] = round(cross, 4)
        log(f"engine agreement: {agree}/{UTTS_TEST} identical, "
            f"cross-WER {cross:.4f}")

        # --- reference LM-ON (same G' artifacts) -------------------------
        if ref_lm_conf is not None:
            t0 = time.time()
            ref_lm_out = subprocess.run([fixed_bin, ref_lm_conf, scp],
                                        capture_output=True, text=True,
                                        timeout=7200)
            dt = time.time() - t0
            assert ref_lm_out.returncode == 0, ref_lm_out.stderr[-2000:]
            ref_lm_hyps = parse_scp_stdout(ref_lm_out.stdout, UTTS_TEST)
            w = wer_of(ref_lm_hyps, truths)
            log(f"reference GC-FIXED LM-ON (30k budget): WER {w:.4f} "
                f"({dt:.0f}s)")
            results["ref_wer_lm_30k"] = round(w, 4)
            if our_lm_hyps is not None:
                agree_lm = sum(1 for a, b in zip(our_lm_hyps, ref_lm_hyps)
                               if a == b)
                results["lm_transcripts_identical"] = \
                    f"{agree_lm}/{UTTS_TEST}"
                results["lm_cross_wer"] = round(
                    wer_of(our_lm_hyps, ref_lm_hyps), 4)
                log(f"LM-on engine agreement: {agree_lm}/{UTTS_TEST}, "
                    f"cross-WER {results['lm_cross_wer']:.4f}")

        # --- deep parity: re-decode mismatches at UNPRUNED budgets -------
        best_beam = max(our_hyps)
        mism = [i for i in range(UTTS_TEST)
                if our_hyps[best_beam][i] != ref_hyps[i]]
        results["mismatches_at_comparable"] = len(mism)
        if mism and os.environ.get("SKIP_DEEP") != "1" and len(mism) <= 6:
            unpruned_bin = os.environ.get(
                "CATEARS_REFERENCE_UNPRUNED_BIN",
                "/tmp/refbuild_unpruned/pocketkaldi")
            if not os.path.exists(unpruned_bin):
                subprocess.run(
                    ["bash", os.path.join(os.path.dirname(__file__),
                                          "build_reference_unpruned.sh")],
                    check=True, capture_output=True, timeout=600)
            deep_scp = os.path.join(OUT, "deep.scp")
            with open(deep_scp, "w") as fd:
                for i in mism:
                    fd.write(f"utt{i} {os.path.join(OUT, f'test{i}.wav')}\n")
            t0 = time.time()
            ref_deep = subprocess.run([unpruned_bin, ref_conf, deep_scp],
                                      capture_output=True, text=True,
                                      timeout=7200)
            assert ref_deep.returncode == 0, ref_deep.stderr[-2000:]
            ref_deep_hyps = parse_scp_stdout(ref_deep.stdout, len(mism))
            cfg = BeamConfig(beam_size=32768, expand_size=131072,
                             eps_expand_size=16384, max_eps_iters=3)
            rec = Recognizer(our_conf, beam_config=cfg)
            ours_deep = [h.split() for _, h in
                         decode_scp(rec, deep_scp,
                                    batch_size=len(mism))]
            deep_agree = sum(1 for a, b in zip(ours_deep, ref_deep_hyps)
                             if a == b)
            ref_empty = sum(1 for h in ref_deep_hyps if not h)
            log(f"deep parity (ours beam 32768 vs reference kBeamSize 3M):"
                f" {deep_agree}/{len(mism)} of the mismatched utterances "
                f"now identical ({time.time() - t0:.0f}s)")
            results["deep_parity"] = f"{deep_agree}/{len(mism)}"
            if ref_empty:
                # An empty reference transcript = its search ended with NO
                # final-reachable token (BestPath best_idx == kNotExist,
                # src/decoder.cc:412) — a reference search failure, not an
                # engine divergence.
                results["deep_ref_empty"] = ref_empty
                log(f"  NOTE: {ref_empty} of the remaining diffs are the "
                    f"reference returning an EMPTY transcript (no "
                    f"final-state token at any budget)")
            if deep_agree < len(mism):
                for j, i in enumerate(mism):
                    if ours_deep[j] != ref_deep_hyps[j]:
                        log(f"  utt{i} STILL differs: "
                            f"ours={' '.join(ours_deep[j][:12])!r} "
                            f"ref={' '.join(ref_deep_hyps[j][:12])!r}")

        # --- headline-scale parity on the two REAL wavs ------------------
        for wav in ("en-us-hello.wav", "en-us-cat.wav"):
            wav_path = os.path.abspath(os.path.join(DATA_DIR, wav))
            r = subprocess.run([fixed_bin, ref_conf, wav_path],
                               capture_output=True, text=True,
                               timeout=3600)
            assert r.returncode == 0, r.stderr[-2000:]
            from catears_tpu.runtime.recognizer import decode_wav_file
            cfg = BeamConfig(beam_size=4096, expand_size=32768,
                             eps_expand_size=8192, max_eps_iters=3)
            ours = decode_wav_file(Recognizer(our_conf, beam_config=cfg),
                                   wav_path)
            same = ours == r.stdout.strip()
            log(f"real-wav parity {wav}: {'IDENTICAL' if same else 'DIFF'}"
                f" (ref={r.stdout.strip()[:80]!r} ours={ours[:80]!r})")
            results[f"real_wav_parity_{wav}"] = bool(same)

    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
