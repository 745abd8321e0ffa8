"""Several devices: meshes, shardings, the fine-tuning step, the long-protein
ring (counterpart of ``metagenomic_deepfri_tpu.parallel``).

- :mod:`mesh` — a 2-D ``DeviceMesh`` with ``data`` / ``model`` axes over
  the ranks of a ``torch.distributed`` process group.
- :mod:`launch` — one rank a device, started from one process
  (:func:`.launch.run_ranks`).
- :mod:`shard` — which dimension of each parameter and batch array is
  split, and the data- and tensor-parallel GCN forward with its
  collectives written out.
- :mod:`train` — the fine-tuning step, on one device or a mesh.
- :mod:`graph_shard` — the node-sharded aggregation and GCN forward.
- :mod:`multihost` — deterministic query sharding across hosts.
"""

from metagenomic_deepfri_tpu_torch.parallel.mesh import make_mesh
from metagenomic_deepfri_tpu_torch.parallel.shard import (batch_pspecs,
                                                          gcn_param_pspecs,
                                                          make_sharded_gcn_forward)
from metagenomic_deepfri_tpu_torch.parallel.train import (TrainState,
                                                          init_train_state,
                                                          make_train_step)

__all__ = [
    "make_mesh",
    "batch_pspecs",
    "gcn_param_pspecs",
    "make_sharded_gcn_forward",
    "TrainState",
    "init_train_state",
    "make_train_step",
]
