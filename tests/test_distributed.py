"""Multi-process tests for catears_tpu.parallel.distributed.

Spawns real OS processes (CPU backend, Gloo collectives through the JAX
coordination service) — the same jax.distributed path a multi-host GPU
deployment uses, minus NVLink/NCCL.  Covers initialize(), local_batch_slice() and
global_sum() across 2 processes x 2 virtual devices each.
"""

import os
import socket
import subprocess
import sys

import pytest

WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np

pid, n, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

from catears_tpu.parallel import distributed

distributed.initialize(f"localhost:{port}", num_processes=n, process_id=pid)
assert jax.process_count() == n, jax.process_count()

# mesh (and anything creating device values) only AFTER initialize
from catears_tpu.parallel.mesh import make_mesh

# Deterministic contiguous split of a non-divisible global batch
lo, hi = distributed.local_batch_slice(5)
assert (lo, hi) == ((0, 3) if pid == 0 else (3, 5)), (pid, lo, hi)
lo, hi = distributed.local_batch_slice(4)
assert (lo, hi) == ((0, 2) if pid == 0 else (2, 4)), (pid, lo, hi)

# Cross-process metric reduction
total = distributed.global_sum(float(pid) + 1.5)
assert abs(total - 4.0) < 1e-9, total

# make_mesh sees all GLOBAL devices (2 procs x 2 local = 4)
mesh = make_mesh()
assert mesh.devices.size == 4, mesh.devices.size
print(f"worker {pid} ok")
"""


DECODE_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np

pid, n, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

from catears_tpu.parallel import distributed

distributed.initialize(f"localhost:{port}", num_processes=n, process_id=pid)
assert jax.device_count() == 4 and len(jax.local_devices()) == 2

# Deterministic pipeline, identical in every process.
from catears_tpu.am.model import AcousticModel
from catears_tpu.am.nnet import build_nnet
from catears_tpu.decode.beam import BeamConfig, decode_chunk, init_beam_batch
from catears_tpu.frontend.fbank import fbank_from_wave, num_frames
from catears_tpu.graph.device import DeviceFst
from catears_tpu.graph.fst import FlatFst
from catears_tpu.graph.transform import prepare_decode_graph
from catears_tpu.parallel.mesh import ShardedPipeline, make_mesh
from catears_tpu.tools.toy import make_phone_loop_graph, make_toy_nnet

rng = np.random.RandomState(0)
graph = make_phone_loop_graph(rng, num_words=10, num_pdfs=64)
nnet = make_toy_nnet(rng, hidden=64, num_pdfs=64, num_tdnn_layers=3)
nnet_def, params = build_nnet(nnet)
prior = np.full(64, 1.0 / 64, np.float32)
am = AcousticModel(nnet_def, params, np.log(prior), graph.tid2pdf,
                   nnet.left_context, nnet.right_context, chunk_size=8,
                   num_pdfs=64)
fst = FlatFst.from_raw(graph.fst)
dec_fst, olab2, mode = prepare_decode_graph(fst)
dfst = DeviceFst.build(dec_fst, graph.tid2pdf,
                       eps_depth_cap=1 if mode != "raw" else None,
                       olabel2=olab2)
cfg = BeamConfig(beam_size=64, expand_size=512, eps_expand_size=256,
                 max_eps_iters=3)

batch, samples = 4, 4000
n_frames = num_frames(samples)
rng2 = np.random.RandomState(7)
wave = (rng2.randn(batch, samples) * 1000).astype(np.float32)
lengths = rng2.randint(n_frames // 2, n_frames + 1,
                       size=batch).astype(np.int32)

# Single-process reference decode, entirely on this process's device 0.
ref_logp = np.stack([
    am.forward(np.asarray(fbank_from_wave(jnp.asarray(wave[i]), n_frames)))
    for i in range(batch)
])
beam_ref, _ = init_beam_batch(cfg, False, batch, dfst, None)
valid = jnp.asarray(np.arange(n_frames)[:, None] < lengths[None, :])
beam_ref, traces_ref = decode_chunk(
    cfg, False, dfst, None, beam_ref,
    jnp.asarray(np.transpose(ref_logp, (1, 0, 2))), valid)
ref_states = np.asarray(beam_ref.states)
ref_costs = np.asarray(beam_ref.costs)
ref_words = np.asarray(traces_ref.words)  # [T, B, K, W]

# Globally sharded decode across 2 processes x 2 local devices.
mesh = make_mesh()  # all 4 global devices on the data axis
pipe = ShardedPipeline(am, dfst, None, cfg, mesh)
wave_g = jax.device_put(wave, pipe.data_sharding)
lens_g = jax.device_put(lengths, pipe.data_sharding)
beam_g = pipe.make_beam(batch)
with mesh:
    step = pipe.jit_full_step(n_frames)
    logp_g, beam_g, traces_g = step(wave_g, beam_g, lens_g)
    jax.block_until_ready(beam_g.costs)

# Each process checks ITS addressable shards against the reference.
checked = 0
for shard in beam_g.states.addressable_shards:
    np.testing.assert_array_equal(np.asarray(shard.data),
                                  ref_states[shard.index])
    checked += 1
for shard in beam_g.costs.addressable_shards:
    np.testing.assert_allclose(np.asarray(shard.data),
                               ref_costs[shard.index], atol=1e-3)
for shard in traces_g.words.addressable_shards:
    np.testing.assert_array_equal(np.asarray(shard.data),
                                  ref_words[shard.index])
assert checked >= 1
print(f"decode worker {pid} ok ({checked} shards checked)")
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_init_slice_and_sum(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(__file__))
    procs = [
        subprocess.Popen([sys.executable, str(script), str(i), "2",
                          str(port)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         env=env, text=True)
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed worker timed out")
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"worker {i} ok" in out


def test_two_process_sharded_decode(tmp_path):
    """ShardedPipeline.full_step across 2 REAL processes x 2 local devices
    on a globally sharded ragged batch must equal the single-process
    decode shard by shard — the multi-host decode path docs/SCALING.md
    describes, executed by CI."""
    script = tmp_path / "decode_worker.py"
    script.write_text(DECODE_WORKER)
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(__file__))
    procs = [
        subprocess.Popen([sys.executable, str(script), str(i), "2",
                          str(port)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         env=env, text=True)
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("sharded decode worker timed out")
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"decode worker {i} ok" in out


def test_single_process_noop():
    """num_processes<=1 must not touch jax.distributed (already inited
    sessions would raise)."""
    from catears_tpu.parallel import distributed

    distributed.initialize(num_processes=1)  # must be a no-op
    lo, hi = distributed.local_batch_slice(7)
    assert (lo, hi) == (0, 7)
    assert distributed.global_sum(2.5) == 2.5
