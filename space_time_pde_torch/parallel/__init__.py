"""Multi-rank training: data parallelism, the x-sharded latent grid with
its halo exchange, and the halo-conv sharded encoders.

Counterpart of ``space_time_pde_tpu/parallel/``, over
``torch.distributed`` process groups (one process and one device a
rank): ``dp`` (process group, ``[data][space]`` mesh, data-parallel
step), ``collectives`` (the differentiable all-reduce and neighbour
exchange), ``halo`` (the sharded query and jet), ``halo_conv``
(``HaloConv3d``, ``ShardedGroupNorm``), ``sharded_unet`` and
``sharded_unet4d`` (the encoders), ``dp_sp`` (the data x space step),
``layout`` (the train CLIs' flags and batches on that world).
Import the modules themselves; this package imports nothing, so that
``models`` can use ``collectives`` without an import cycle.
"""
