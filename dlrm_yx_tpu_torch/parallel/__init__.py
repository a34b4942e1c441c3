"""Multi-device training: whole-table (hybrid) sharding over a
``torch.distributed`` mesh, one process a device.

``sharders`` (table placement), ``plan`` (the static layout), ``mesh`` (the
("data", "model") process groups), ``multihost`` (joining or starting a
world), ``hybrid`` (the sharded steps and ``HybridRunner``) and
``overlap`` (the all-to-all / bottom-MLP order in a trace): the port of
``dlrm_yx_tpu/parallel``'s table-sharded path.
"""
