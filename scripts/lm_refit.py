"""Refit the delta-LM G' of a finished realism run and re-score LM-on.

Rebuilds the training corpus (from OUT_DIR/corpus.txt if the run saved
it, else by replaying the run's deterministic rng stream), fits a
bigram with the given interpolation weight, rewrites lm.fst / lm.uni in
place, and decodes the run's test set LM-on with ours and the reference
binary.  Lets LM-estimation variants be swept without re-training the
acoustic model (~15 min saved per point).

Run: LM_INTERP=0.3 OUT_DIR=/tmp/realism_noisy SNR=0.5 python
     scripts/lm_refit.py
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax

from catears_tpu.utils.device import enable_compile_cache  # noqa: E402

enable_compile_cache()

OUT = os.environ.get("OUT_DIR", "/tmp/realism")
WORDS = int(os.environ.get("WORDS", 50000))
NUM_PHONES = int(os.environ.get("NUM_PHONES", 200))
VARIANTS = int(os.environ.get("VARIANTS", 6))
UTTS_TRAIN = int(os.environ.get("UTTS_TRAIN", 240))
SECONDS = float(os.environ.get("SECONDS", 8.0))
SNR = float(os.environ.get("SNR", 0.12))
HIDDEN = int(os.environ.get("HIDDEN", 1024))
LM_INTERP = float(os.environ.get("LM_INTERP", 0.0))
LM_SHARP = float(os.environ.get("LM_SHARP", 1.0))
FIXED_BIN = os.environ.get("CATEARS_REFERENCE_FIXED_BIN",
                           "/tmp/refbuild_fixed/pocketkaldi")


def log(msg):
    print(f"# {msg}", file=sys.stderr, flush=True)


def get_corpus_and_graph():
    from catears_tpu.tools.biggraph import make_trie_graph
    from catears_tpu.tools.synth import Synthesizer
    from catears_tpu.tools.toy import make_toy_nnet

    rng = np.random.RandomState(0)
    g = make_trie_graph(rng, num_words=WORDS, num_phones=NUM_PHONES,
                        variants=VARIANTS)
    corpus_path = os.path.join(OUT, "corpus.txt")
    if os.path.exists(corpus_path):
        words = [[int(w) for w in line.split()]
                 for line in open(corpus_path)]
        return g, words
    # Replay the realism rng stream EXACTLY: Synthesizer then
    # make_toy_nnet consume `rng` before the utterance loop.
    synth = Synthesizer(g, NUM_PHONES, VARIANTS, rng, markov=True,
                        snr_noise=SNR)
    make_toy_nnet(rng, hidden=HIDDEN, num_pdfs=g.num_pdfs,
                  num_tdnn_layers=5)
    frames = int(SECONDS * 100)
    words = []
    for _ in range(UTTS_TRAIN):
        _s, _t, ws = synth.utterance(rng, frames)
        words.append(ws)
    return g, words


def main():
    from catears_tpu.decode.beam import BeamConfig
    from catears_tpu.io.binfmt import write_pkfst, write_vec0
    from catears_tpu.runtime.batch import decode_scp
    from catears_tpu.runtime.recognizer import Recognizer
    from catears_tpu.tools.arpa import arpa_to_fst
    from catears_tpu.tools.lm import fit_bigram_arpa, read_unigram_costs
    from catears_tpu.tools.score import edit_distance

    g, train_words = get_corpus_and_graph()
    log(f"corpus: {sum(len(w) for w in train_words)} tokens")
    vocab_list = [f"word{i}" for i in range(1, WORDS + 1)]
    corpus = [[f"word{w}" for w in ws] for ws in train_words]
    arpa_path = os.path.join(OUT, f"corpus_i{LM_INTERP}_s{LM_SHARP}.arpa")
    with open(arpa_path, "w") as fd:
        fd.write("\n".join(fit_bigram_arpa(
            corpus, vocab_list, interpolate=LM_INTERP,
            sharpness=LM_SHARP)) + "\n")
    vocab_map = {w: i for i, w in enumerate(vocab_list, start=1)}
    vocab_map["<s>"] = WORDS + 1
    vocab_map["</s>"] = WORDS + 2
    gfst, _ = arpa_to_fst(arpa_path, vocab=vocab_map)
    log(f"lam={LM_INTERP} s={LM_SHARP} G': {gfst.num_states} states {gfst.num_arcs} "
        f"arcs")
    with open(os.path.join(OUT, "lm.fst"), "wb") as fd:
        write_pkfst(fd, gfst.to_raw())
    uni_vec = np.zeros(WORDS + 3, np.float32)
    uni_vec[1:WORDS + 1] = g.unigram_cost[1:]
    uni_vec[WORDS + 1] = 0.0
    eos = read_unigram_costs(arpa_path)
    uni_vec[WORDS + 2] = -eos["</s>"] * np.log(10.0)
    with open(os.path.join(OUT, "lm.uni"), "wb") as fd:
        write_vec0(fd, uni_vec)

    truth = {}
    for line in open(os.path.join(OUT, "truth.txt")):
        p = line.split()
        truth[p[0]] = p[1:]

    def wer(hyps):
        errs = tot = 0
        for k in truth:
            r = edit_distance(truth[k], hyps.get(k, []))
            errs += r[0]
            tot += len(truth[k])
        return errs / tot

    ours2048 = None
    for beam in (2048, 4096):
        cfg = BeamConfig(beam_size=beam, expand_size=32768,
                         eps_expand_size=8192, max_eps_iters=3)
        rec = Recognizer(os.path.join(OUT, "ours_lm.conf"),
                         beam_config=cfg)
        t0 = time.time()
        ours = {k: v.split() for k, v in
                decode_scp(rec, os.path.join(OUT, "test.scp"),
                           batch_size=10)}
        log(f"lam={LM_INTERP} s={LM_SHARP} OURS beam={beam} LM-on WER "
            f"{wer(ours):.4f} ({time.time() - t0:.0f}s)")
        if beam == 2048:
            ours2048 = ours
    r = subprocess.run([FIXED_BIN, os.path.join(OUT, "ref_lm.conf"),
                        os.path.join(OUT, "test.scp")],
                       capture_output=True, text=True, timeout=3600)
    assert r.returncode == 0, r.stderr[-500:]
    ref = {}
    for line in r.stdout.splitlines():
        if line.startswith("utt"):
            p = line.split()
            ref[p[0]] = p[1:]
    agree = sum(1 for k in ours2048 if ours2048[k] == ref[k])
    log(f"lam={LM_INTERP} s={LM_SHARP} REF 30k LM-on WER {wer(ref):.4f}, "
        f"agreement vs ours@2048 {agree}/{len(truth)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
