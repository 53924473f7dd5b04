"""Multi-device serving in one process: the ("data", "model") mesh and its
two collectives (`mesh.py`), the exact top-k over a sharded corpus
(`sharded_topk.py`) and tensor-parallel weights with positions stepped in
lockstep (`tp.py`). Counterpart of `rag_serving_system_tpu/parallel/`."""

from rag_serving_system_torch.parallel.mesh import Mesh, make_mesh, mesh_axis_sizes
from rag_serving_system_torch.parallel.sharded_topk import (
    shard_corpus,
    sharded_cosine_topk,
)
