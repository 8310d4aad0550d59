"""Data-parallel and index-sharded runs over ``torch.distributed``.

The port of ``bioseqdb_tpu/dist``: ``mesh`` (process group and device
mesh set-up, row padding, a rank's rows, the gather of host results),
``launch`` (one process per rank, with a deadline) and ``shard_index``
(the BWT-interval-sharded FM-index and the device pipeline over it).
"""
