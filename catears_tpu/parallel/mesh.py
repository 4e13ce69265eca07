"""Device-mesh scale-out: data-parallel utterances + tensor-parallel AM.

The reference is strictly single-threaded, single-process (SURVEY.md §2);
scale-out here is new, idiomatic design: a `jax.sharding.Mesh` with axes

  data   — utterance batch dimension (beam state, features, traces)
  model  — acoustic-model weight sharding (column-parallel linears)

Shardings are annotated with NamedSharding / with_sharding_constraint and
XLA GSPMD inserts the collectives (all-gather/psum over NVLink), following the
scaling-book recipe: pick a mesh, annotate, let the compiler partition.

Pipeline/sequence/expert parallelism do not apply to this architecture: the
AM is a small feed-forward TDNN (no layer pipeline depth, no MoE), and
sequence scaling is streaming chunking (SURVEY.md §5) — the batch 'data'
axis is where throughput scales.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from catears_tpu.am.model import AcousticModel
from catears_tpu.am.nnet import nnet_forward
from catears_tpu.decode.beam import (
    BeamConfig,
    BeamState,
    decode_chunk,
    init_beam_batch,
)
from catears_tpu.frontend.fbank import fbank_from_wave
from catears_tpu.graph.device import DeviceFst, DeviceLm


def make_mesh(num_devices: Optional[int] = None,
              model_parallel: int = 1) -> Mesh:
    """('data', 'model') mesh over the first num_devices devices."""
    devices = jax.devices()
    n = num_devices or len(devices)
    assert n % model_parallel == 0, (n, model_parallel)
    dp = n // model_parallel
    dev_array = np.array(devices[:n]).reshape(dp, model_parallel)
    return Mesh(dev_array, ("data", "model"))


def shard_am_params(am: AcousticModel, mesh: Mesh):
    """Column-shard every linear layer over the 'model' axis.

    W [in, out] -> P(None, 'model'); b [out] -> P('model').  Activations
    between layers stay feature-sharded; XLA propagates and inserts the
    all-gathers needed around splice/normalize boundaries.
    """
    sharded = []
    for layer, p in zip(am.nnet_def, am.params):
        # np.asarray first: device_put of a single-device jnp array into a
        # global sharding is rejected in multi-process runs; the host
        # value is identical on every process, so placing local shards
        # from it is always legal.
        if layer[0] == "linear":
            sharded.append({
                "w": jax.device_put(np.asarray(p["w"]),
                                    NamedSharding(mesh, P(None, "model"))),
                "b": jax.device_put(np.asarray(p["b"]),
                                    NamedSharding(mesh, P("model"))),
            })
        elif layer[0] == "batchnorm":
            sharded.append({
                "scale": jax.device_put(np.asarray(p["scale"]),
                                        NamedSharding(mesh, P("model"))),
                "offset": jax.device_put(np.asarray(p["offset"]),
                                         NamedSharding(mesh, P("model"))),
            })
        else:
            sharded.append(jax.tree.map(np.asarray, p))
    return sharded


class ShardedPipeline:
    """Batched wave -> features -> AM -> beam-search step over a mesh."""

    def __init__(self, am: AcousticModel, dfst: DeviceFst,
                 dlm: Optional[DeviceLm], cfg: BeamConfig, mesh: Mesh):
        self.am = am
        self.cfg = cfg
        self.mesh = mesh
        self.params = shard_am_params(am, mesh)
        self.data_sharding = NamedSharding(mesh, P("data"))
        self.repl = NamedSharding(mesh, P())
        # Replicate the graph tables and prior EXPLICITLY over the mesh.
        # In a single process XLA would reshard committed single-device
        # inputs on the fly; in a multi-process (multi-host) run every
        # input of a global computation must already be a global array,
        # so the replication has to be stated (docs/SCALING.md).
        rep = lambda x: jax.device_put(np.asarray(x), self.repl)  # noqa: E731
        self.dfst = jax.tree.map(rep, dfst)
        self.dlm = jax.tree.map(rep, dlm) if dlm is not None else None
        self.log_prior = rep(am.log_prior)

    def am_step(self, wave: jnp.ndarray, n_frames: int) -> jnp.ndarray:
        """[B, S] padded wave -> [B, T, P] log-likelihoods (dp x tp)."""

        def one_utt(w):
            feats = fbank_from_wave(w, n_frames)
            padded = jnp.concatenate([
                jnp.repeat(feats[:1], self.am.left_context, axis=0),
                feats,
                jnp.repeat(feats[-1:], self.am.right_context, axis=0),
            ])
            out = nnet_forward(self.am.nnet_def, self.params, padded)
            return out - self.log_prior

        wave = jax.lax.with_sharding_constraint(wave, self.data_sharding)
        logp = jax.vmap(one_utt)(wave)
        return jax.lax.with_sharding_constraint(logp, self.data_sharding)

    def full_step(self, wave: jnp.ndarray, beam: BeamState,
                  lengths: Optional[jnp.ndarray] = None, *,
                  n_frames: int):
        """One streaming step: wave chunk in, updated beam + traces out.

        lengths ([B] i32, optional) supports RAGGED batches: utterance b
        decodes only its first lengths[b] frames; the padded tail runs
        identity frames (frame_valid=0 in the device scan), exactly like
        decode_batch's host path.  None = every frame valid.
        """
        logp = self.am_step(wave, n_frames)  # [B, T, P]
        logp_t = jnp.transpose(logp, (1, 0, 2))  # [T, B, P]
        if lengths is None:
            valid = jnp.ones((logp_t.shape[0], logp_t.shape[1]), bool)
        else:
            lengths = jax.lax.with_sharding_constraint(
                lengths, self.data_sharding)
            valid = (jnp.arange(logp_t.shape[0], dtype=jnp.int32)[:, None]
                     < lengths[None, :])
        beam, traces = decode_chunk(self.cfg, self.dlm is not None,
                                    self.dfst, self.dlm, beam, logp_t, valid)
        return logp, beam, traces

    def jit_full_step(self, n_frames: int):
        return jax.jit(
            functools.partial(self.full_step, n_frames=n_frames))

    def make_beam(self, batch: int) -> BeamState:
        beam, _ = init_beam_batch(self.cfg, self.dlm is not None, batch,
                                  self.dfst, self.dlm)
        return BeamState(*(
            jax.device_put(x, self.data_sharding) for x in beam))
