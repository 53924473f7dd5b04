"""The sharded top-k over a mesh that spans two processes.

    python -m rag_serving_system_torch.dryrun_multihost [--device cpu]

The counterpart of `scripts/dryrun_multihost.py`. The parent spawns two
workers on a free port. Each joins the group (`parallel.mesh.initialize`,
gloo over TCP), builds the global (4, 2) mesh of 2 x 4 positions
(`make_global_mesh`: the "data" axis spans the process boundary), places its
own half of the corpus (`shard_corpus`) and runs `sharded_cosine_topk`,
whose candidate all-gather crosses the process boundary. Each holds the ids
against a numpy stable-argsort oracle on the whole corpus and prints one
line, a JSON object with its rank, its ids and "parity": "ok" or "FAIL".
The parent prints the workers' lines, then MULTIHOST PASS or MULTIHOST FAIL,
and exits 0 or 1.

The JAX script's shapes: N = 1000, D = 64, B = 8, K = 5, data from
`default_rng(42)`. The positions are on the card (cuda:0 for both workers on
one card, a card each where there are more) unless `--device cpu` is given.
A worker that fails or does not finish in time ends the run: the parent
kills every worker and fails.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

N_PROC = 2
LOCAL_POSITIONS = 4
MESH_SHAPE = "4,2"
N_DOCS, DIM, B, K = 1000, 64, 8, 5
TIMEOUT_S = 300


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(argvs: list[list[str]], timeout_s: float, env=None) -> list[tuple[int, str]]:
    """Start one process for each argv at once and wait for all:
    [(returncode, stdout and stderr)] in order. Once one fails (its peers
    would wait on it until the group's timeout) or `timeout_s` has passed,
    every process still running is killed; a killed process's code is
    negative."""
    import time

    procs = [subprocess.Popen(a, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env) for a in argvs]
    outs = [""] * len(procs)
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.poll() is None for p in procs):
            failed = any(p.returncode not in (None, 0) for p in procs)
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for i, p in enumerate(procs):
            outs[i] = p.communicate()[0]
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def local_devices(device: str, rank: int, n: int) -> list:
    """This worker's n positions: all on the CPU, or all on one card (the
    rank's own card where there are enough, else cuda:0)."""
    import torch

    if device == "cpu":
        return [torch.device("cpu")] * n
    cards = torch.cuda.device_count()
    return [torch.device("cuda", rank if cards >= N_PROC else 0)] * n


def child(rank: int, coord: str, device: str) -> int:
    import numpy as np
    import torch

    from rag_serving_system_torch.device import resolve_device
    from rag_serving_system_torch.parallel import mesh as pmesh
    from rag_serving_system_torch.parallel.sharded_topk import shard_corpus, sharded_cosine_topk

    torch.set_num_threads(1)
    resolve_device(device)   # raises where CUDA is asked for and absent
    pmesh.initialize(coord, N_PROC, rank, timeout_s=TIMEOUT_S / 2)
    try:
        mesh = pmesh.make_global_mesh(MESH_SHAPE, local_devices(device, rank, LOCAL_POSITIONS))
        if sum(mesh.addressable) != LOCAL_POSITIONS or mesh.process_count != N_PROC:
            raise RuntimeError(f"rank {rank} holds {sum(mesh.addressable)} positions of {mesh}")

        rng = np.random.default_rng(42)   # the same data in both processes
        corpus = rng.standard_normal((N_DOCS, DIM)).astype(np.float32)
        corpus /= np.linalg.norm(corpus, axis=-1, keepdims=True)
        queries = rng.standard_normal((B, DIM)).astype(np.float32)

        shards = shard_corpus(torch.as_tensor(corpus), mesh)
        _, idx = sharded_cosine_topk(shards, torch.as_tensor(queries), K, mesh,
                                     valid_n=N_DOCS)
        idx = idx.cpu().numpy()

        qn = queries / np.linalg.norm(queries, axis=-1, keepdims=True)
        want = np.argsort(-(qn @ corpus.T), axis=1, kind="stable")[:, :K]
        ok = np.array_equal(idx, want)
        print(json.dumps({"rank": rank, "parity": "ok" if ok else "FAIL",
                          "processes": mesh.process_count, "mesh": mesh.shape,
                          "devices": [str(d) for d in mesh.devices],
                          "ids": idx.tolist(), "oracle": want.tolist()}), flush=True)
        return 0 if ok else 1
    finally:
        pmesh.shutdown()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--child", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--coord", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        return child(args.child, args.coord, args.device)
    coord = f"127.0.0.1:{free_port()}"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p)
    results = run_workers(
        [[sys.executable, "-m", "rag_serving_system_torch.dryrun_multihost",
          "--device", args.device, "--child", str(rank), "--coord", coord]
         for rank in range(N_PROC)], TIMEOUT_S,
        env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=path))
    ok = True
    for rank, (rc, out) in enumerate(results):
        lines = [x for x in out.splitlines() if x.startswith('{"rank"')]
        ok = ok and rc == 0 and len(lines) == 1 and json.loads(lines[0])["parity"] == "ok"
        print(lines[0] if lines else f"[worker {rank}] rc={rc}\n{out[-3000:]}", flush=True)
    print("MULTIHOST PASS" if ok else "MULTIHOST FAIL", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
