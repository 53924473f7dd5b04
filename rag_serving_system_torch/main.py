"""Composition root of the PyTorch port:

    python -m rag_serving_system_torch.main

Settings → corpus → engine (models and corpus on TORCH_DEVICE, default cuda)
→ queue backend (Redis iff REDIS_URL) → batch processor → the HTTP surface
of `api/endpoints.py` (aiohttp, imported only here), and with
NATIVE_FRONT_PORT the C++ epoll front of `api/native_front.py` beside it.
The counterpart of the root `main.py`, with its three roles
(ROLE=all|api|engine).
"""

from __future__ import annotations

import json
import logging
import os

logger = logging.getLogger("rag_serving_system_torch.main")


def _front_port(settings) -> int:
    """NATIVE_FRONT_PORT (0: no native front). The front answers its waiters
    from this process's result store, so a shared Redis queue, whose results
    another replica may store, is refused."""
    port = int(os.environ.get("NATIVE_FRONT_PORT", "0") or 0)
    if port and settings.redis_url:
        raise SystemExit(
            "NATIVE_FRONT_PORT requires the in-memory queue (single-replica "
            "role=all); unset REDIS_URL or the front")
    return port


def _native_front(request_queue, port: int):
    """The C++ epoll front (`native/httpfront.cc`) listening on `port` over
    `request_queue`, and the FrontQueue that routes its results back: the
    queue the processor and the aiohttp app see. Its in-flight cap is
    NATIVE_FRONT_MAX_INFLIGHT, by default MAX_QUEUE_SIZE (0: none). A front
    that cannot be built or bound ends the process with the reason."""
    import atexit

    from rag_serving_system_torch.api.native_front import FrontQueue, NativeFront

    max_inflight = int(os.environ.get("NATIVE_FRONT_MAX_INFLIGHT",
                                      os.environ.get("MAX_QUEUE_SIZE", "0")))
    try:
        front = NativeFront(request_queue, port=port, max_inflight=max_inflight).start()
    except RuntimeError as e:
        raise SystemExit(f"NATIVE_FRONT_PORT={port}: the native front did not start: "
                         f"{e}") from e
    atexit.register(front.stop)   # joins the epoll thread on shutdown
    return FrontQueue(request_queue, front)


def _mesh(settings):
    """The ("data", "model") mesh over every visible CUDA device, shaped by
    MESH_SHAPE, when MESH_SHAPE is set, the engine runs on CUDA and more
    than one device is visible; else None (one device). Unlike the root
    `main.py`, an unset MESH_SHAPE serves on one card: the mesh turns packed
    prefill, the int8 corpus and IVF off, and one process serves slower over
    several cards than on one (its host-bound decode takes turns)."""
    import torch

    from rag_serving_system_torch.device import resolve_device
    from rag_serving_system_torch.parallel.mesh import make_mesh

    n = torch.cuda.device_count()
    if n < 2 or resolve_device().type != "cuda":
        return None
    if not settings.mesh_shape:
        logger.info("%d CUDA devices visible: serving on one; set MESH_SHAPE=dp,tp "
                    "to serve over a mesh of them", n)
        return None
    mesh = make_mesh(settings.mesh_shape)
    logger.info("mesh: %s over %d devices", mesh.shape, mesh.size)
    return mesh


def build_processor(settings=None, documents=None, doc_embeddings=None, mesh=None):
    """(processor, engine, request_queue, settings), the processor not yet
    started. Settings come from the environment when not given; the corpus
    from DOCUMENT_TEXT_FILE and DOCUMENT_EMBEDDINGS_FILE unless `documents`
    and `doc_embeddings` (N, D) are passed; the mesh over the visible CUDA
    devices (`_mesh`) unless `mesh` is passed."""
    import numpy as np

    from rag_serving_system_torch.config import get_settings
    from rag_serving_system_torch.core.batch_processor import BatchProcessor
    from rag_serving_system_torch.core.engine import RagEngine
    from rag_serving_system_torch.core.request_queue import make_queue

    settings = settings or get_settings()
    if documents is None:
        logger.info("loading corpus: %s", settings.document_text_file)
        with open(settings.document_text_file, "r", encoding="utf-8") as f:
            documents = json.load(f)
    if doc_embeddings is None:
        doc_embeddings = np.load(settings.document_embeddings_file)
    engine = RagEngine(settings, documents, doc_embeddings,
                       mesh=mesh if mesh is not None else _mesh(settings))
    request_queue = make_queue(settings)
    processor = BatchProcessor(request_queue, engine,
                               polling_interval=min(settings.polling_interval, 0.05))
    return processor, engine, request_queue, settings


def build_app(settings=None, warmup: bool = True, role: str = "all"):
    """(app, processor, engine, settings) with the processor running.

    `role` splits the service across processes (one process's HTTP parsing,
    queue work and host staging share one interpreter lock):
      - "all"    — API and engine in one process
      - "api"    — the HTTP front only: takes requests into the shared Redis
                   queue and serves result polls. No torch, no model
                   (app, None, None, settings). Run several behind one port
                   with REUSE_PORT=1.
      - "engine" — the queue's consumer only: owns the device, drains the
                   Redis queue, stores results. No HTTP surface
                   (None, processor, engine, settings).
    The api and engine roles need REDIS_URL: the queue is what joins them."""
    from rag_serving_system_torch.config import get_settings

    settings = settings or get_settings()
    max_queue_size = int(os.environ.get("MAX_QUEUE_SIZE", "0"))
    if role == "api":
        if not settings.redis_url:
            raise SystemExit("ROLE=api requires REDIS_URL (shared queue)")
        from rag_serving_system_torch.api.endpoints import create_api
        from rag_serving_system_torch.core.request_queue import make_queue

        request_queue = make_queue(settings)
        logger.info("role=api: queue backend %s, no engine in-process",
                    type(request_queue).__name__)
        return (create_api(request_queue, None, None, max_queue_size=max_queue_size),
                None, None, settings)
    if role == "engine" and not settings.redis_url:
        raise SystemExit("ROLE=engine requires REDIS_URL (shared queue)")
    if role not in ("all", "engine"):
        raise SystemExit(f"ROLE={role}: all, api or engine")
    front_port = _front_port(settings)

    processor, engine, request_queue, settings = build_processor(settings)
    logger.info("queue backend: %s", type(request_queue).__name__)
    if warmup:
        engine.warmup()
    if front_port:
        request_queue = processor.request_queue = _native_front(request_queue, front_port)
    processor.start()
    if role == "engine":
        logger.info("role=engine: consuming the shared queue, no HTTP surface")
        return None, processor, engine, settings
    from rag_serving_system_torch.api.endpoints import create_api

    app = create_api(request_queue, processor, engine, max_queue_size=max_queue_size)
    return app, processor, engine, settings


def main() -> None:
    import signal
    import threading

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    role = os.environ.get("ROLE", "all")
    app, processor, _, settings = build_app(role=role)
    drain = float(os.environ.get("DRAIN_TIMEOUT", "30"))
    if role == "engine":
        # headless consumer: block until SIGTERM / SIGINT, then drain
        stop = threading.Event()
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
        signal.signal(signal.SIGINT, lambda *_: stop.set())
        try:
            stop.wait()
        finally:
            logger.info("draining in-flight work before exit...")
            processor.stop(drain_timeout=drain)
        return
    from rag_serving_system_torch.api.endpoints import run_app

    try:
        # aiohttp's run_app handles SIGTERM / SIGINT itself and returns
        run_app(app, host=settings.host, port=settings.port,
                reuse_port=os.environ.get("REUSE_PORT", "0") in ("1", "true"))
    finally:
        if processor is not None:
            logger.info("draining in-flight work before exit...")
            processor.stop(drain_timeout=drain)


if __name__ == "__main__":
    main()
