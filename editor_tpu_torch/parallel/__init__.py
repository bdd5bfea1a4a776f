"""Data parallelism on ``torch.distributed``: counterpart of the
data-parallel part of ``editor_tpu/parallel`` (one process per device,
NCCL on CUDA, gloo on the CPU).

* :mod:`.multihost` - ``initialize`` (the default group from the launcher's
  environment), ``barrier``, ``shutdown``, ``fail_fast``, ranks;
* :mod:`.mesh` - the ('data', 'model') ``DeviceMesh`` and a rank's rows;
* :mod:`.collectives` - the twelve collectives of the JAX module,
  differentiable where those are;
* :mod:`.compression` - the gradient reducers (mean, fp16, bf16, int8,
  PowerSGD);
* :mod:`.ddp` - the explicit local-batch step with a reducer;
* :mod:`.zero` - ZeRO-1 (optimizer slots partitioned over the ranks).

The global-batch step on a mesh is ``engine.train.build_train_step(mesh=)``.
FSDP, LocalSGD, the launcher's rendezvous modules and model parallelism are
not ported.
"""

from editor_tpu_torch.parallel.collectives import (all_gather, all_reduce, all_to_all,
                                                   barrier, broadcast, gather,
                                                   ppermute_shift, reduce, reduce_scatter,
                                                   scatter, send_recv)
from editor_tpu_torch.parallel.compression import Reducer, make_reducer
from editor_tpu_torch.parallel.ddp import LeafLayout, build_ddp_train_step
from editor_tpu_torch.parallel.mesh import make_mesh, replicated, shard_batch, shard_host_batch
from editor_tpu_torch.parallel.zero import (Zero1Optimizer, state_memory_bytes,
                                            zero1_state_shardings)

__all__ = ["LeafLayout", "Reducer", "Zero1Optimizer", "all_gather", "all_reduce",
           "all_to_all", "barrier", "broadcast", "build_ddp_train_step", "gather",
           "make_mesh", "make_reducer", "ppermute_shift", "reduce", "reduce_scatter",
           "replicated", "scatter", "send_recv", "shard_batch", "shard_host_batch",
           "state_memory_bytes", "zero1_state_shardings"]
