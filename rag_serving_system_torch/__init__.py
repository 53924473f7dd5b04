"""rag_serving_system_torch — the RAG serving path in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of `rag_serving_system_tpu` (JAX/Pallas), which stays the reference:
every module here keeps its counterpart's tensor layouts at its public
functions, so the two can be held against each other on the same inputs.

- device.py  the explicit device and dtype (TORCH_DEVICE, default cuda)
- config.py  the settings read from the environment
- ops/       the kernels' wrappers, each beside its plain PyTorch version,
             and the nvcc build (sources in csrc/)
- models/    e5 (XLM-RoBERTa) encoder and Qwen2 decoder as functions on
             dicts of tensors in the JAX (in, out) layout
- core/      serving engine, batch processor, request queues, retrievers
- parallel/  the ("data", "model") mesh of one process, the sharded top-k,
             tensor-parallel weights
- api/       the HTTP surface (aiohttp)
- utils/     the memo LRU, stage timers, the RESP client
- main.py    the service (python -m rag_serving_system_torch.main;
             ROLE=all|api|engine)

The package imports nothing of `rag_serving_system_tpu`: where it needs a
host module of the JAX package, it keeps its own copy, under the same name.

What is served: the request path with every setting of the JAX package's
(the prefix-KV cache with its hit, miss and bypass routes, the quantized
decoder, the continuous decode pool, speculative greedy decode, HF
checkpoints and tokenizers, the pipelined batch processor, the api and
engine roles), on one device or over a mesh of several (`parallel/`); what
the port does not implement makes the engine raise (core/engine.py).
"""

__version__ = "0.1.0"
