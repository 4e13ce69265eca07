"""catears_tpu — a batched speech-to-text inference framework on JAX/XLA.

A from-scratch JAX/XLA re-design with the capabilities of
ishine/CatEars (pocketkaldi): 16 kHz PCM -> log-mel fbank features ->
nnet3-style feed-forward acoustic model -> frame-synchronous Viterbi beam
search over an HCLG WFST, with optional on-the-fly big-LM (delta-LM)
rescoring.

Unlike the reference (single-threaded mobile C++), everything here is
batch-first, dense and jit-compiled: utterances x frames x beam slots are
arrays, WFST arcs live in device-resident CSR tables, pruning is an exact
top-k, and scale-out happens over a `jax.sharding.Mesh`.

Reference behavioral contract: /root/reference (pocketkaldi), see SURVEY.md.
"""

__version__ = "0.1.0"

from catears_tpu.io.config import Configuration
from catears_tpu.utils.errors import (
    CatEarsError,
    CorruptionError,
    IOError_,
    last_error,
)

__all__ = [
    "Configuration",
    "CatEarsError",
    "CorruptionError",
    "IOError_",
    "last_error",
    "__version__",
]
