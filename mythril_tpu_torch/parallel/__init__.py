"""Device-mesh parallelism for the probe solver and frontier search.

The reference is a single-threaded CPU tool (SURVEY.md §2.8); its only
parallelism is Z3-internal.  The port's counterpart of
``mythril_tpu/parallel``: a 2-D ``(path, cand)`` mesh of CUDA devices in
one process (``mesh.py``), over which the probe's candidate blocks spread
(``probe.py``: one lowering launch per block on its device, the small
reductions on the mesh's first device) and whose path axis shards the
frontier's slot batch; across hosts a corpus splits by contract
(``corpus.py``, shard identity from ``torch.distributed``).
"""

from mythril_tpu_torch.parallel.corpus import run_corpus, shard_corpus, shard_identity
from mythril_tpu_torch.parallel.mesh import (
    CAND_AXIS,
    PATH_AXIS,
    make_frontier_mesh,
    shard_frontier_inputs,
    shard_probe_args,
)
from mythril_tpu_torch.parallel.probe import (
    evaluate_batch_sharded,
    frontier_step,
    pack_frontier,
)

__all__ = [
    "run_corpus",
    "shard_corpus",
    "shard_identity",
    "CAND_AXIS",
    "PATH_AXIS",
    "make_frontier_mesh",
    "shard_frontier_inputs",
    "shard_probe_args",
    "evaluate_batch_sharded",
    "frontier_step",
    "pack_frontier",
]
