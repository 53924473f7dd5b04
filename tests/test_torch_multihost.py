"""PyTorch port: the sharded top-k over a mesh that spans two processes
(`rag_serving_system_torch/dryrun_multihost.py`), and the pieces it joins.

`python -m rag_serving_system_torch.dryrun_multihost --device cpu` spawns two
gloo workers over one (4, 2) mesh; both must print their parity line and the
run MULTIHOST PASS. Their ids must equal the numpy stable-argsort oracle and
the JAX package's `sharded_cosine_topk` on the same data, run here over the
conftest's 8 CPU devices as a (4, 2) mesh. Every wait on a child is bounded
by `communicate(timeout=...)`."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rag_serving_system_tpu.parallel import mesh as jax_mesh  # noqa: E402
from rag_serving_system_tpu.parallel import sharded_topk as jax_sharded  # noqa: E402
from rag_serving_system_torch import dryrun_multihost as dm  # noqa: E402
from rag_serving_system_torch.parallel import mesh as pmesh  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _data():
    rng = np.random.default_rng(42)
    corpus = rng.standard_normal((dm.N_DOCS, dm.DIM)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=-1, keepdims=True)
    queries = rng.standard_normal((dm.B, dm.DIM)).astype(np.float32)
    return corpus, queries


def test_two_process_topk_equals_the_oracle_and_jax():
    env = dict(os.environ, TORCH_DEVICE="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-m", "rag_serving_system_torch.dryrun_multihost", "--device", "cpu"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        out, _ = proc.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, out[-3000:]
    assert out.strip().splitlines()[-1] == "MULTIHOST PASS"
    lines = [json.loads(x) for x in out.splitlines() if x.startswith('{"rank"')]
    assert sorted(r["rank"] for r in lines) == [0, 1]

    corpus, queries = _data()
    qn = queries / np.linalg.norm(queries, axis=-1, keepdims=True)
    oracle = np.argsort(-(qn @ corpus.T), axis=1, kind="stable")[:, :dm.K]
    mesh = jax_mesh.make_mesh(dm.MESH_SHAPE)
    assert mesh.devices.size == 8
    with mesh:
        _, jidx = jax_sharded.sharded_cosine_topk(
            jax_sharded.shard_corpus(jnp.asarray(corpus), mesh), jnp.asarray(queries),
            dm.K, mesh, valid_n=dm.N_DOCS)
    for r in lines:
        assert r["parity"] == "ok" and r["processes"] == 2
        assert r["mesh"] == {"data": 4, "model": 2}
        np.testing.assert_array_equal(np.asarray(r["ids"]), oracle)
        np.testing.assert_array_equal(np.asarray(r["ids"]), np.asarray(jidx))


def test_a_failing_worker_fails_the_run_and_its_peer_is_killed():
    """A worker that exits non-zero ends the wait at once: the one still
    blocked (here, sleeping) is killed, not waited for."""
    import time

    t0 = time.monotonic()
    res = dm.run_workers([[sys.executable, "-c", "import sys; sys.exit(3)"],
                          [sys.executable, "-c", "import time; time.sleep(60)"]], 120)
    assert time.monotonic() - t0 < 30
    assert res[0][0] == 3 and res[1][0] < 0


def test_one_process_mesh_is_the_local_mesh():
    """Outside a process group every position is this process's, and the
    host gather returns the tensor alone."""
    m = pmesh.make_mesh("2,2", devices=["cpu"] * 4)
    assert m.process_count == 1 and all(m.addressable) and m.local_lead == m.lead
    t = torch.arange(6).reshape(2, 3)
    assert torch.equal(pmesh.process_allgather(t), t)


def test_engine_refuses_a_mesh_of_several_processes():
    from rag_serving_system_torch import config
    from rag_serving_system_torch.core.engine import RagEngine

    m = pmesh.Mesh([["cpu"], ["cpu"]], owners=[[0], [1]], rank=0)
    assert m.process_count == 2 and m.addressable == [True, False]
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="one process"):
        RagEngine(config.Settings(model_preset="tiny"), ["a", "b"],
                  rng.standard_normal((2, 64)).astype(np.float32), mesh=m)


_PADDED_WORKER = r'''
import json, sys
import numpy as np
import torch
from rag_serving_system_torch.ops.topk import cosine_topk_reference
from rag_serving_system_torch.parallel import mesh as pmesh
from rag_serving_system_torch.parallel.sharded_topk import shard_corpus, sharded_cosine_topk

torch.set_num_threads(1)
rank, coord = int(sys.argv[1]), sys.argv[2]
pmesh.initialize(coord, 2, rank, timeout_s=60)
try:
    mesh = pmesh.make_global_mesh("2,2", ["cpu", "cpu"])
    rng = np.random.default_rng(5)
    corpus = torch.as_tensor(rng.standard_normal((1003, 50)).astype(np.float32))
    corpus = corpus / corpus.norm(dim=-1, keepdim=True)
    corpus[7] = corpus[700]                       # a tie across the processes' halves
    queries = torch.as_tensor(rng.standard_normal((5, 50)).astype(np.float32))
    queries[0] = corpus[700]
    shards = shard_corpus(corpus, mesh)
    one = pmesh.make_mesh("2,2", devices=["cpu"] * 4)
    out = {}
    for k in (1, 7, 40):
        s, i = sharded_cosine_topk(shards, queries, k, mesh, valid_n=1003)
        s1, i1 = sharded_cosine_topk(shard_corpus(corpus, one), queries, k, one, valid_n=1003)
        _, ri = cosine_topk_reference(corpus, queries, k)
        out[k] = bool(torch.equal(i, i1) and torch.equal(s, s1) and torch.equal(i, ri))
    print(json.dumps({"rank": rank, "held": [s is not None for s in shards],
                      "shard_rows": [s.shape[0] for s in shards if s is not None],
                      "equal": out}), flush=True)
finally:
    pmesh.shutdown()
'''


def test_two_processes_pad_rows_and_ties_as_one_process():
    """1003 rows over 2 x 2 positions (one pad row, depth 50 padded to 64),
    a tie between the halves: each process holds its two shards, and at
    k = 1, 7, 40 its ids and scores equal the one-process sharded top-k's
    and the plain stable top-k's (the lower index first)."""
    coord = f"127.0.0.1:{dm.free_port()}"
    env = dict(os.environ, PYTHONPATH=ROOT, TORCH_DEVICE="cpu", OMP_NUM_THREADS="1")
    res = dm.run_workers([[sys.executable, "-c", _PADDED_WORKER, str(r), coord]
                          for r in range(2)], 120, env=env)
    for rank, (rc, out) in enumerate(res):
        assert rc == 0, out[-3000:]
        rec = json.loads(out.strip().splitlines()[-1])
        assert rec["held"] == [rank == 0, rank == 0, rank == 1, rank == 1]
        assert rec["shard_rows"] == [251, 251]
        assert rec["equal"] == {"1": True, "7": True, "40": True}
