"""Multi-device training over a ``torch.distributed`` mesh, one process a
device: whole-table (hybrid), row and column sharding.

``sharders`` (table placement), ``plan`` (the static layout), ``mesh`` (the
("data", "model") process groups), ``multihost`` (joining or starting a
world), ``runner`` (the runner interface the Trainer drives and the mesh
runners' base: their constructor, bodies and checkpoints), ``hybrid`` (the
table-sharded step and ``HybridRunner``),
``row_sharded`` / ``col_sharded`` (the big tables split by rows or by
columns, ``RowShardedRunner`` / ``ColShardedRunner``) and ``overlap`` (the
all-to-all / bottom-MLP order in a trace): the port of
``dlrm_yx_tpu/parallel``.
"""
