"""dlrm_yx_tpu_torch — the PyTorch / CUDA port of ``dlrm_yx_tpu``.

A second package beside the JAX one, for one NVIDIA H100. It keeps the JAX
package's module names (``config``, ``data``, ``ops``, ``models``,
``train``, ``cli``) and its public layouts (MLP weights ``[in, out]``,
indices ``[T, B, L]`` int32, pooled ``[T, B, D]``, slots ``[B, S, D]``).
Plain tensor work is PyTorch; each TPU kernel of the JAX package becomes a
hand-written CUDA kernel under ``csrc/``, built at first use by
``ops/_build.py``, with its plain PyTorch version beside it for CPU tensors.

Ported so far: the single-device training path (``cli`` ->
``Trainer.fit`` -> the runner -> ``make_multistep_train_step``, with the
optimizers and their
sparse-update routing in ``optim/``, its steps replayed from CUDA graphs
in ``train/capture.py``) and the serving path (``cli --inference-only``
-> ``Trainer.evaluate`` -> ``make_eval_step``), on random, trace-driven
(``data/trace.py``), Criteo (``data/criteo.py``, ``data/criteo_bin.py``)
or processed data (``data/processed.py``), with checkpoints
(``train/checkpoint.py``), the embedding variants (QR tables,
``ops/qr_embedding.py``; mixed dims, ``ops/md_embedding.py``; weighted
pooling), quantized serving (``ops/quantized.py``), model export and the
execution trace (``export.py``), the profiling and debug flags, the
reference-checkpoint and visualization tools (``tools/``), all six
kernels (K1–K6), and whole-table (hybrid) sharding over a
``torch.distributed`` mesh of one process a device (``parallel/``: the
CLI's --mesh-data / --mesh-model / --distributed / --force-cpu-devices);
row and column sharding are left. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``. Beside DLRM it trains HSTU, the
generative recommender's sequential transducer (``models/hstu.py``,
``ops/hstu_attention.py``), through the same path on one device. The
package imports nothing of JAX or ``dlrm_yx_tpu``.
"""
