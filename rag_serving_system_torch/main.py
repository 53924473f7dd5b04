"""Composition root of the PyTorch port:

    python -m rag_serving_system_torch.main

Settings → corpus → engine (models and corpus on TORCH_DEVICE, default cuda)
→ queue backend (Redis iff REDIS_URL) → batch processor → the HTTP surface
of `api/endpoints.py` (aiohttp, imported only here).
The counterpart of `main.py` in role "all".
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np

from rag_serving_system_torch.config import get_settings
from rag_serving_system_torch.core.batch_processor import BatchProcessor
from rag_serving_system_torch.core.engine import RagEngine
from rag_serving_system_torch.core.request_queue import make_queue

logger = logging.getLogger("rag_serving_system_torch.main")


def build_processor(settings=None, documents=None, doc_embeddings=None):
    """(processor, engine, request_queue, settings), the processor not yet
    started. Settings come from the environment when not given; the corpus
    from DOCUMENT_TEXT_FILE and DOCUMENT_EMBEDDINGS_FILE unless `documents`
    and `doc_embeddings` (N, D) are passed."""
    settings = settings or get_settings()
    if documents is None:
        logger.info("loading corpus: %s", settings.document_text_file)
        with open(settings.document_text_file, "r", encoding="utf-8") as f:
            documents = json.load(f)
    if doc_embeddings is None:
        doc_embeddings = np.load(settings.document_embeddings_file)
    engine = RagEngine(settings, documents, doc_embeddings)
    request_queue = make_queue(settings)
    processor = BatchProcessor(request_queue, engine,
                               polling_interval=min(settings.polling_interval, 0.05))
    return processor, engine, request_queue, settings


def build_app(settings=None, warmup: bool = True):
    """(app, processor, engine, settings) with the processor running."""
    from rag_serving_system_torch.api.endpoints import create_api

    processor, engine, request_queue, settings = build_processor(settings)
    if warmup:
        engine.warmup()
    processor.start()
    app = create_api(request_queue, processor, engine,
                     max_queue_size=int(os.environ.get("MAX_QUEUE_SIZE", "0")))
    return app, processor, engine, settings


def main() -> None:
    from rag_serving_system_torch.api.endpoints import run_app

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    role = os.environ.get("ROLE", "all")
    if role != "all":
        raise SystemExit(f"ROLE={role}: the PyTorch port serves role 'all' only")
    app, processor, _, settings = build_app()
    try:
        run_app(app, host=settings.host, port=settings.port,
                reuse_port=os.environ.get("REUSE_PORT", "0") in ("1", "true"))
    finally:
        logger.info("draining in-flight work before exit...")
        processor.stop(drain_timeout=float(os.environ.get("DRAIN_TIMEOUT", "30")))


if __name__ == "__main__":
    main()
