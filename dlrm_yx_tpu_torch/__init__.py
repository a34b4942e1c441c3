"""dlrm_yx_tpu_torch — the PyTorch / CUDA port of ``dlrm_yx_tpu``.

A second package beside the JAX one, for one NVIDIA H100. It keeps the JAX
package's module names (``config``, ``data``, ``ops``, ``models``,
``train``, ``cli``) and its public layouts (MLP weights ``[in, out]``,
indices ``[T, B, L]`` int32, pooled ``[T, B, D]``, slots ``[B, S, D]``).
Plain tensor work is PyTorch; each TPU kernel of the JAX package becomes a
hand-written CUDA kernel under ``csrc/``, built at first use by
``ops/_build.py``, with its plain PyTorch version beside it for CPU tensors.

Ported so far: the single-device training path (``cli`` ->
``Trainer.fit`` -> ``make_train_step``, with the optimizers and their
sparse-update routing in ``optim/``, its steps replayed from CUDA graphs
in ``train/capture.py``) and the serving path (``cli --inference-only``
-> ``Trainer.evaluate`` -> ``make_eval_step``), on random, trace-driven
(``data/trace.py``) or Criteo data (``data/criteo.py``,
``data/criteo_bin.py``), with checkpoints (``train/checkpoint.py``), and
all six kernels (K1–K6). Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``. The package imports nothing of JAX or
``dlrm_yx_tpu``.
"""
