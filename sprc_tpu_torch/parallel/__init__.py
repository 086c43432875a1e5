"""Data parallelism over ``torch.distributed`` (counterpart of
``sprc_tpu/parallel/``): one process per device, rank 0 the main process.
:mod:`.dist` holds the rank helpers, :mod:`.mesh` the process group and its
collectives, :mod:`.dryrun` a tiny-width run of every sharded path."""
