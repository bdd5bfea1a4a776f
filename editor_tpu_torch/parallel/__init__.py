"""Data, model and pipeline parallelism on ``torch.distributed``:
counterpart of ``editor_tpu/parallel`` (one process per device, NCCL on
CUDA, gloo on the CPU).

* :mod:`.multihost` - ``initialize`` (the default group from the launcher's
  environment), ``barrier``, ``shutdown``, ``fail_fast``, ranks;
* :mod:`.mesh` - the ('data', 'model') or ('data', 'stage', 'model')
  ``DeviceMesh`` and a rank's rows;
* :mod:`.collectives` - the twelve collectives of the JAX module,
  differentiable where those are;
* :mod:`.compression` - the gradient reducers (mean, fp16, bf16, int8,
  PowerSGD);
* :mod:`.ddp` - the explicit local-batch step with a reducer;
* :mod:`.zero` - ZeRO-1 (optimizer slots partitioned over the ranks);
* :mod:`.fsdp` - FSDP / ZeRO-3 (parameters, gradients and slots sharded);
* :mod:`.localsgd` - LocalSGD (periodic parameter averaging);
* :mod:`.elastic`, :mod:`.rendezvous`, :mod:`.etcd` - the launcher's
  supervisor, rendezvous stores and backends (``cli.launch``);
* :mod:`.tp` - tensor parallelism of the backbone over the 'model' axis
  (the shard-major qkv permutation, Megatron shards, canonical checkpoints);
* :mod:`.moe` - the GShard mixture of experts (index dispatch, expert
  parallelism over an 'expert' group);
* :mod:`.ring` - ring and Ulysses (masked) attention over a 'seq' group;
* :mod:`.pipeline` - the GPipe schedule over a 'stage' group (one process a
  stage, point-to-point activations), skips, ``balance_stages``;
* :mod:`.pipeline_vit` - the EDITOR backbone through it;
* :mod:`.deferred_bn` - BatchNorm statistics of the mini-batch under
  microbatching;
* :mod:`.sharded_tensor` - chunk and enumerable sharding specs as DTensors
  over the mesh;
* :mod:`.rpc` - the host-side RPC control plane on ``torch.distributed.rpc``
  (functions sent by reference: no lambdas or closures).

The global-batch step on a mesh is ``engine.train.build_train_step(mesh=)``
(tensor-parallel when the mesh's model axis is above 1, pipelined with
``backbone=make_pipeline_backbone(mesh, M)``), with ZeRO-1
(``zero1_state_shardings``) or FSDP (``engine.train.fsdp_state_shardings``)
on any ('data', 'stage', 'model') mesh: their slots and blocks are
partitioned over the data group, each model rank's over its own shards.
The compressed local-batch step (``build_ddp_train_step``) runs on a
model axis too, its reducers over the data group on the canonical leaves.
As in JAX, ``rpc`` and ``sharded_tensor`` are modules of their own, not
re-exported here.
"""

from editor_tpu_torch.parallel.collectives import (all_gather, all_reduce, all_to_all,
                                                   barrier, broadcast, gather,
                                                   ppermute_shift, reduce, reduce_scatter,
                                                   scatter, send_recv)
from editor_tpu_torch.parallel.compression import Reducer, make_reducer
from editor_tpu_torch.parallel.ddp import LeafLayout, build_ddp_train_step
from editor_tpu_torch.parallel.deferred_bn import (bn_acc_init, bn_params_init,
                                                   deferred_bn_apply, deferred_bn_commit)
from editor_tpu_torch.parallel.etcd import EtcdServer, EtcdStore
from editor_tpu_torch.parallel.fsdp import fsdp_shardings, param_memory_bytes, shard_params
from editor_tpu_torch.parallel.mesh import make_mesh, replicated, shard_batch, shard_host_batch
from editor_tpu_torch.parallel.moe import MoEParams, moe_ffn, moe_ffn_dense, moe_init
from editor_tpu_torch.parallel.pipeline import (balance_stages, init_skips, pipeline_apply,
                                                pipeline_train_step, pop,
                                                profile_layer_costs, stash)
from editor_tpu_torch.parallel.pipeline_vit import (PipelineBackbone, make_pipeline_backbone,
                                                    make_stage_fn)
from editor_tpu_torch.parallel.ring import (ring_attention, ring_masked_attention,
                                            ulysses_attention, ulysses_masked_attention)
from editor_tpu_torch.parallel.tp import (permute_qkv_params, qkv_tp_permutation,
                                          shard_editor, shard_state_dict)
from editor_tpu_torch.parallel.rendezvous import (DynamicRendezvous, FileStore,
                                                  RendezvousClosedError, RendezvousHandler,
                                                  RendezvousHandlerRegistry,
                                                  RendezvousParameters, TCPStore,
                                                  all_gather_object, broadcast_object,
                                                  monitored_barrier, rendezvous_registry)
from editor_tpu_torch.parallel.zero import (Zero1Optimizer, state_memory_bytes,
                                            zero1_state_shardings)

__all__ = ["DynamicRendezvous", "EtcdServer", "EtcdStore", "FileStore", "LeafLayout",
           "MoEParams", "PipelineBackbone", "Reducer", "RendezvousClosedError", "RendezvousHandler",
           "RendezvousHandlerRegistry", "RendezvousParameters", "TCPStore",
           "Zero1Optimizer", "all_gather", "all_gather_object", "all_reduce", "all_to_all",
           "balance_stages", "barrier", "bn_acc_init", "bn_params_init", "broadcast",
           "broadcast_object", "build_ddp_train_step", "deferred_bn_apply",
           "deferred_bn_commit", "fsdp_shardings", "gather", "init_skips", "make_mesh",
           "make_pipeline_backbone", "make_reducer", "make_stage_fn", "moe_ffn",
           "moe_ffn_dense", "moe_init", "monitored_barrier", "param_memory_bytes",
           "permute_qkv_params", "pipeline_apply", "pipeline_train_step", "pop",
           "ppermute_shift", "profile_layer_costs", "qkv_tp_permutation", "reduce",
           "reduce_scatter", "rendezvous_registry", "replicated", "ring_attention",
           "ring_masked_attention", "scatter", "send_recv", "shard_batch", "shard_editor",
           "shard_host_batch", "shard_params", "shard_state_dict", "stash",
           "state_memory_bytes", "ulysses_attention", "ulysses_masked_attention",
           "zero1_state_shardings"]
