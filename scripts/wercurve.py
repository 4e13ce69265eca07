"""WER vs beam size on the 50k-word trie at configurable difficulty.

Justifies the production beam geometry against the reference's 30k-token
budget (reference src/decoder.h:54): decodes the same planted utterances
at several beam sizes and reports WER + capacity high-water for each.

AMP controls the planted pseudo-likelihood peakiness (tools/biggraph.py
plant_logp): 10.0 is the headline bench's easy setting (~75% target mass),
lower is harder (amp=8 ~ 33%, amp=7 ~ 16% of the probability mass on the
target pdf, rest on confusable pdfs).

Run: AMP=8 BEAMS=1024,2048,4096,8192 python scripts/wercurve.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from catears_tpu.utils.device import enable_compile_cache  # noqa: E402

enable_compile_cache()

from catears_tpu.decode.beam import (
    BeamConfig,
    FrameTrace,
    backtrace_device,
    decode_chunk,
    init_beam_batch,
)
from catears_tpu.decode.hyp import assemble_words
from catears_tpu.graph.device import DeviceFst
from catears_tpu.graph.transform import prepare_decode_graph
from catears_tpu.tools.biggraph import make_trie_graph, plant_logp
from catears_tpu.tools.score import edit_distance

BATCH = int(os.environ.get("BATCH", 8))
SECONDS = float(os.environ.get("SECONDS", 10.0))
WORDS = int(os.environ.get("BENCH_WORDS", 50000))
AMP = float(os.environ.get("AMP", 8.0))
BEAMS = [int(b) for b in os.environ.get(
    "BEAMS", "1024,2048,4096,8192,16384").split(",")]
CHUNK = 100

rng = np.random.RandomState(0)
print(f"# building {WORDS}-word trie...", file=sys.stderr)
tg = make_trie_graph(rng, num_words=WORDS)
fst, olab2, mode = prepare_decode_graph(tg.fst)
dfst = DeviceFst.build(fst, tg.tid2pdf,
                       group=int(os.environ.get("GROUP", 2)),
                       csr_group=int(os.environ.get("CSR_GROUP", 8)) or None,
                       eps_depth_cap=1 if mode != "raw" else None,
                       olabel2=olab2)
frames = int(SECONDS * 100) - 2
logp, true_words = plant_logp(rng, tg, BATCH, frames, amp=AMP)
logp_t = jnp.asarray(np.transpose(logp, (1, 0, 2)))  # [T, B, P]


def decode(cfg):
    beam, init_trace = init_beam_batch(cfg, False, BATCH, dfst, None)
    chunks = []
    for off in range(0, frames, CHUNK):
        n = min(CHUNK, frames - off)
        if n == CHUNK:
            lp = jax.lax.dynamic_slice_in_dim(logp_t, off, n, axis=0)
        else:
            lp = jnp.concatenate(
                [logp_t[off:off + n],
                 jnp.zeros((CHUNK - n,) + logp_t.shape[1:], jnp.float32)])
        valid = jnp.zeros((CHUNK, BATCH), bool).at[:n].set(True)
        beam, trace = decode_chunk(cfg, False, dfst, None, beam, lp, valid)
        chunks.append(jax.tree.map(lambda x: x[:n], trace))
    traces = FrameTrace(
        jnp.concatenate([init_trace.prev_slot[None]]
                        + [c.prev_slot for c in chunks]),
        jnp.concatenate([init_trace.words[None]]
                        + [c.words for c in chunks]))
    total = beam.costs + jnp.where(
        beam.states >= 0, dfst.final[jnp.maximum(beam.states, 0)], jnp.inf)
    has_final = jnp.isfinite(total).any(axis=1)
    best = jnp.where(has_final, jnp.argmin(total, axis=1),
                     jnp.argmin(beam.costs, axis=1)).astype(jnp.int32)
    words = backtrace_device(traces, best)
    return (np.asarray(words), np.asarray(beam.overflow),
            np.asarray(beam.hiwater))


results = []
for k in BEAMS:
    expand = int(os.environ.get("EXPAND", 0)) or min(8 * k, 131072)
    # One-pass closure expands children of ALL candidates (pre-dedup), so
    # the eps capacity scales with the expansion, not the beam.
    eps = int(os.environ.get("EPS_EXPAND", 0)) or max(4096, k)
    cfg = BeamConfig(beam_size=k, expand_size=expand,
                     eps_expand_size=eps, max_eps_iters=3)
    t0 = time.perf_counter()
    words, overflow, hiwater = decode(cfg)
    dt = time.perf_counter() - t0
    hyps = [assemble_words(words[b]) for b in range(BATCH)]
    errs = sum(edit_distance(true_words[b], hyps[b])[0]
               for b in range(BATCH))
    ref_len = max(1, sum(len(t) for t in true_words))
    wer = errs / ref_len
    hw = hiwater.max(axis=0)
    row = {"beam": k, "amp": AMP, "wer": round(wer, 4),
           "overflow": bool(overflow.any()),
           "hiwater": [int(v) for v in hw],
           "expand": expand, "wall_s": round(dt, 1)}
    results.append(row)
    print(json.dumps(row), flush=True)

print(json.dumps({"metric": "wer_vs_beam", "amp": AMP,
                  "curve": results}))
